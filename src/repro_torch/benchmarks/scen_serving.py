"""Open-loop serving scenario: trace-driven tail latency vs offered load.

Every other scenario is closed-loop; here requests arrive on their own
clock (seeded Poisson or bursty traces, ``repro_torch.core.arrivals``)
and push pipeline-parallel decode flows through the schedules on a live
fabric via the engines' streaming ``advance`` path.  Four tenants share
the VCI banks and NICs; the per-request metric is arrival-to-delivery
latency, summarized as p50/p99/p999 tails plus goodput, per offered
load level — the regime where late partitions compound into queueing
delay instead of per-step slack.
"""

from __future__ import annotations

import functools

from ..core import simulator as sim
from .common import DEVICE, ENGINE, module_main

APPROACHES = ("pt2pt_single", "part", "pt2pt_many")  # bulk baseline first
ARRIVALS = ("poisson", "bursty")
RATES_RPS = (8000, 20000)  # light load vs near wire saturation
# One request = a decode step crossing 4 pipeline stages: theta=8
# activation partitions of 128 KiB per hop, partition readiness ramped
# over 40 us of per-stage compute (the early-bird overlap window).
FIXED = dict(n_requests=256, n_tenants=4, n_stages=4, theta=8,
             part_bytes=131072.0, n_vcis=4, compute_us=40.0,
             window_us=5.0, seed=3)


@functools.lru_cache(maxsize=None)
def _results(engine: str, device):
    out = []
    for arrival in ARRIVALS:
        for rate in RATES_RPS:
            base = None
            for ap in APPROACHES:
                r = sim.simulate_serving(ap, arrival=arrival,
                                         rate_rps=float(rate),
                                         engine=engine, device=device,
                                         **FIXED)
                d = r.as_dict()
                if ap == "pt2pt_single":
                    base = r.p99_s
                d["gain_vs_bulk_p99"] = base / r.p99_s
                out.append(d)
    return tuple(out)


def results(engine: str = ENGINE, device=DEVICE):
    """Scenario results as dicts (computed once per engine and device;
    rows() reuses them)."""
    return list(_results(engine, device))


def rows(engine: str = ENGINE, device=DEVICE):
    out = []
    for d in results(engine, device):
        out.append((
            f"serving/{d['approach']}/{d['arrival']}"
            f"/{int(round(d['offered_rps'] / 1000))}krps",
            d["p99_us"],
            f"p50={d['p50_us']:.1f}us,p999={d['p999_us']:.1f}us,"
            f"goodput={d['goodput_rps']:.0f}rps,"
            f"gain99={d['gain_vs_bulk_p99']:.2f}",
        ))
    return out


if __name__ == "__main__":
    import sys
    module_main(sys.modules[__name__])
