"""Fault-injection scenario: goodput and re-agreement cost under faults.

Two panels on the robustness axis the paper's clean-fabric benchmarks
never exercise:

* **drops** — the 4x4 torus halo exchange on a lossy fabric
  (``repro_torch.core.faults``): a message carrying k partitions is
  dropped with probability ``1 - (1 - p)^k`` and re-enters the live
  queues after its ack timeout, so the bulk message (k = every
  partition) both drops near-certainly and resends the whole buffer,
  while the partitioned plan resends only the lost chunks — the goodput
  gap is the partitioned API's robustness win;
* **membership** — a rank leaves the ring mid-steady-state: quiesce,
  ``runtime.elastic.plan_mesh`` re-plan, CommPlan re-agreement and the
  cold-fabric warm-up all land on the measured clock.

Everything is seeded (drop draws from the spec's ``SeedSequence``,
events declared) — reruns are bit-for-bit.
"""

from __future__ import annotations

import functools

from ..core import simulator as sim
from ..core.faults import FaultSpec, RankFailure
from .common import DEVICE, ENGINE, module_main

APPROACHES = ("pt2pt_single", "part", "pt2pt_many")  # bulk baseline first
FAULT_RATES = (0.01, 0.05)  # light loss vs heavy loss
# The faults sweep spec's operating point: 4x4 torus, 128 KiB faces
# split into theta=8 partitions, 2 VCIs, 50 us ack timeout.
FIXED = dict(dims=(4, 4), face_bytes=(131072.0, 131072.0), theta=8,
             n_vcis=2)
TIMEOUT_US = 50.0
SEED = 3
# Membership panel: 8 ranks at model_parallel=2, rank 3 leaves at 60 us.
MEMBER = dict(n_ranks=8, theta=8, part_bytes=16384.0, n_vcis=2,
              n_iters=12, model_parallel=2)


@functools.lru_cache(maxsize=None)
def _results(engine: str, device):
    kw = dict(engine=engine, device=device)
    out = []
    for rate in FAULT_RATES:
        spec = FaultSpec(drop_prob=rate, timeout_us=TIMEOUT_US, seed=SEED)
        base = None
        for ap in APPROACHES:
            r = sim.simulate_faulty(ap, faults=spec, **FIXED, **kw)
            d = r.as_dict()
            if ap == "pt2pt_single":
                base = r.goodput_bps
            d["goodput_vs_bulk"] = r.goodput_bps / base
            out.append(d)
    for ap in ("pt2pt_single", "part"):
        spec = FaultSpec(failures=(RankFailure(3, t_fail_us=60.0),))
        r = sim.simulate_membership(ap, faults=spec, **MEMBER, **kw)
        out.append(r.as_dict())
    return tuple(out)


def results(engine: str = ENGINE, device=DEVICE):
    """Scenario results as dicts (computed once per engine and device;
    rows() reuses them)."""
    return list(_results(engine, device))


def rows(engine: str = ENGINE, device=DEVICE):
    out = []
    for d in results(engine, device):
        if d["scenario"] == "faulty":
            out.append((
                f"faults/{d['approach']}/p{d['drop_prob']:g}",
                d["tts_us"],
                f"goodput={d['goodput_gbps']:.1f}GB/s,"
                f"retx={d['n_retransmits']},rounds={d['rounds']},"
                f"vs_bulk={d['goodput_vs_bulk']:.2f}",
            ))
        else:
            out.append((
                f"faults/membership/{d['approach']}",
                d["tts_us"],
                f"reagree={d['reagree_us']:.1f}us,"
                f"warmup={d['warmup_us']:.2f}us,"
                f"plan={d['plan_data']}x{d['plan_model']}",
            ))
    return out


if __name__ == "__main__":
    import sys
    module_main(sys.modules[__name__])
