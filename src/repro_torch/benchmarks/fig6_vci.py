"""Paper Fig 6: same as Fig 5 but with 32 VCIs.  Headline: Pt2Pt many
matches single; part drops from ~30x to ~3-4x (a ~10x contention cut);
RMA many now beats RMA single."""

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
                            part_bytes=size / 32, n_vcis=32, **kw).time_us
        for ap in APPROACHES:
            r = sim.simulate(ap, n_threads=32, theta=1, part_bytes=size / 32,
                             n_vcis=32, **kw)
            out.append((f"fig6/{ap}/{size}B", r.time_us,
                        f"penalty={r.time_us / base:.1f}x"))
    # the headline contention-reduction factor
    t1 = sim.simulate("part", n_threads=32, theta=1, part_bytes=2,
                      n_vcis=1, **kw).time_us
    t32 = sim.simulate("part", n_threads=32, theta=1, part_bytes=2,
                       n_vcis=32, **kw).time_us
    out.append(("fig6/part_contention_reduction", t1 / t32,
                "paper: ~10x (30x -> 3-4x)"))
    return out


if __name__ == "__main__":
    import sys
    module_main(sys.modules[__name__])
