"""Paper Fig 7: message aggregation — 4 threads, theta=32 partitions per
thread, aggregation thresholds 0/512/2048/16384 B.  Headline: the ~10x
no-aggregation penalty drops to ~3x; crossover at N_part * aggr_size."""

from ..core import simulator as sim
from .common import DEVICE, ENGINE, module_main

SIZES = [2048, 8192, 32768, 131072, 1 << 20, 8 << 20]  # global buffer bytes
AGGRS = [0, 512, 2048, 16384]


def rows(engine: str = ENGINE, device=DEVICE):
    kw = dict(engine=engine, device=device)
    out = []
    n_part = 4 * 32
    for size in SIZES:
        base = sim.simulate("pt2pt_single", n_threads=4, theta=32,
                            part_bytes=size / n_part, **kw).time_us
        many = sim.simulate("pt2pt_many", n_threads=4, theta=32,
                            part_bytes=size / n_part, **kw).time_us
        out.append((f"fig7/pt2pt_single/{size}B", base, "reference"))
        out.append((f"fig7/pt2pt_many/{size}B", many,
                    f"penalty={many / base:.1f}x"))
        for aggr in AGGRS:
            r = sim.simulate("part", n_threads=4, theta=32,
                             part_bytes=size / n_part, aggr_bytes=aggr, **kw)
            out.append((f"fig7/part_aggr{aggr}/{size}B", r.time_us,
                        f"penalty={r.time_us / base:.1f}x,"
                        f"msgs={r.n_messages}"))
    return out


if __name__ == "__main__":
    import sys
    module_main(sys.modules[__name__])
