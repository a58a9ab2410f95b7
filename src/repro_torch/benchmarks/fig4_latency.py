"""Paper Fig 4: single thread, single partition — API comparison across
message sizes.  Validates: improved partitioned path == Pt2Pt single; old
AM path slower everywhere; RMA sync overhead at small sizes; convergence
to wire bandwidth at large sizes."""

from ..core import simulator as sim
from .common import DEVICE, ENGINE, SIZES_SMALL_TO_LARGE, module_main

APPROACHES = ("part", "part_old", "pt2pt_single", "pt2pt_many",
              "rma_single_passive", "rma_many_passive",
              "rma_single_active", "rma_many_active")


def rows(engine: str = ENGINE, device=DEVICE):
    out = []
    for size in SIZES_SMALL_TO_LARGE:
        theo = sim.theoretical_time(size) / 1e-6
        out.append((f"fig4/theoretical_bw/{size}B", theo, "beta=25GB/s"))
        for ap in APPROACHES:
            r = sim.simulate(ap, n_threads=1, theta=1, part_bytes=size,
                             engine=engine, device=device)
            out.append((f"fig4/{ap}/{size}B", r.time_us,
                        f"x_bw={r.time_us / max(theo, 1e-9):.2f}"))
    return out


if __name__ == "__main__":
    import sys
    module_main(sys.modules[__name__])
