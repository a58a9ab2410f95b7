"""Paper Fig 5: thread congestion — 32 threads, one partition each, one
VCI.  Headline: part/many pay ~30x the single-message time at small
sizes."""

from ..core import simulator as sim
from .common import DEVICE, ENGINE, module_main

SIZES = [64, 512, 4096, 65536, 1 << 20]
APPROACHES = ("pt2pt_single", "part", "pt2pt_many",
              "rma_single_passive", "rma_many_passive")


def rows(engine: str = ENGINE, device=DEVICE):
    kw = dict(engine=engine, device=device)
    out = []
    for size in SIZES:
        base = sim.simulate("pt2pt_single", n_threads=32, theta=1,
                            part_bytes=size / 32, **kw).time_us
        for ap in APPROACHES:
            r = sim.simulate(ap, n_threads=32, theta=1, part_bytes=size / 32,
                             **kw)
            out.append((f"fig5/{ap}/{size}B", r.time_us,
                        f"penalty={r.time_us / base:.1f}x"))
    return out


if __name__ == "__main__":
    import sys
    module_main(sys.modules[__name__])
