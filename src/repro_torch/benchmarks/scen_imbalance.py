"""Load-imbalance scenario: per-rank compute noise from Appendix A.

Every rank of a ring draws its per-partition compute times from a
:class:`~repro_torch.core.perfmodel.Workload`'s ``mu * S * N(1, sigma)``
model (``sigma = (eps + delta) / 2``), so partitions become ready at
staggered, stochastic times.  The partitioned path overlaps the
resulting delay (early-bird injection); bulk sends wait for the slowest
thread.  The emitted rows carry both the empirical mean delay and eq
(8)'s analytic ``gamma_theta * S`` so drift between the model and the
engine is visible at a glance.  ``seed`` is threaded from
``repro_torch.benchmarks.run --seed`` for reproducible JSON output.
"""

from __future__ import annotations

import functools

from ..core import perfmodel as pm
from ..core import simulator as sim
from .common import DEVICE, ENGINE, module_main

APPROACHES = ("pt2pt_single", "part", "pt2pt_many")  # bulk baseline first
WORKLOADS = ("fft", "stencil")
N_RANKS, N_THREADS, THETA, PART_BYTES, N_VCIS = 8, 4, 4, 1 << 20, 2


@functools.lru_cache(maxsize=None)
def _results(seed: int, engine: str, device):
    out = []
    for wl_name in WORKLOADS:
        wl = pm.WORKLOADS[wl_name]
        base = None
        for ap in APPROACHES:
            r = sim.simulate_imbalance(ap, n_ranks=N_RANKS, workload=wl,
                                       theta=THETA, part_bytes=PART_BYTES,
                                       n_threads=N_THREADS, n_vcis=N_VCIS,
                                       seed=seed, engine=engine,
                                       device=device)
            d = r.as_dict()
            d["workload"] = wl_name
            if ap == "pt2pt_single":
                base = r.time_s
            d["gain_vs_bulk"] = base / r.time_s
            out.append(d)
    return tuple(out)


def results(seed: int = 0, engine: str = ENGINE, device=DEVICE):
    """Scenario results as dicts (cached per seed, engine and device;
    rows() reuses them)."""
    return list(_results(seed, engine, device))


def rows(seed: int = 0, engine: str = ENGINE, device=DEVICE):
    out = []
    for d in results(seed, engine, device):
        out.append((
            f"imbalance/{d['workload']}/{d['approach']}",
            d["time_us"],
            f"delay={d['mean_delay_us']:.1f}us,"
            f"model={d['model_delay_us']:.1f}us,"
            f"gain={d['gain_vs_bulk']:.2f}",
        ))
    return out


if __name__ == "__main__":
    import sys
    module_main(sys.modules[__name__])
