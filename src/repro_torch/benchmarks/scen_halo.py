"""1-D halo-exchange scenario: R simulated ranks, send + recv per neighbor.

The stencil pattern of Collom et al. ("Persistent and Partitioned MPI for
Stencil Communication"): every rank exchanges its theta boundary
partitions with both neighbors each step.  Sweeps the rank count and
compares the partitioned path (per-partition injection, early-bird under
a delayed last partition) against bulk per-neighbor sends.
"""

from __future__ import annotations

import functools

from ..core import simulator as sim
from .common import DEVICE, ENGINE, module_main

APPROACHES = ("pt2pt_single", "part", "pt2pt_many")  # bulk baseline first
RANKS = (2, 4, 8, 16)
# Fig-8-style imbalance: the last boundary partition is gamma-delayed.
# gamma is chosen so the delay exceeds one link's wire time — the regime
# where early-bird injection pays (below it, the wire is the bottleneck
# for every approach and the gain pins to 1.0).
THETA, PART_BYTES, GAMMA = 4, 4 << 20, 250.0


@functools.lru_cache(maxsize=None)
def _results(engine: str, device):
    out = []
    ready = sim.delayed_ready(1, THETA, PART_BYTES, GAMMA)
    for ranks in RANKS:
        base = None
        for ap in APPROACHES:
            r = sim.simulate_halo(ap, n_ranks=ranks, theta=THETA,
                                  part_bytes=PART_BYTES, ready=ready,
                                  n_vcis=2, engine=engine, device=device)
            d = r.as_dict()
            if ap == "pt2pt_single":
                base = r.time_s
            d["gain_vs_bulk"] = base / r.time_s
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
            f"halo/{d['approach']}/{d['n_ranks']}ranks",
            d["time_us"],
            f"msgs={d['n_messages']},gain={d['gain_vs_bulk']:.2f}",
        ))
    return out


if __name__ == "__main__":
    import sys
    module_main(sys.modules[__name__])
