"""Paper Fig 8: early-bird gain with gamma=100 us/MB, 4 threads, 4
partitions.  Headline: measured gain ~2.54 vs theoretical 2.67; break-even
near ~100 kB; gain agnostic to the API used."""

from ..core import perfmodel as pm
from ..core import simulator as sim
from .common import DEVICE, ENGINE, module_main

SIZES = [16 << 10, 64 << 10, 256 << 10, 1 << 20, 4 << 20, 16 << 20]
GAMMA = 100.0


def gain(ap, s_part, engine: str = ENGINE, device=DEVICE):
    ready = sim.delayed_ready(4, 1, s_part, GAMMA)
    tp = sim.simulate(ap, n_threads=4, theta=1, part_bytes=s_part,
                      ready=ready, engine=engine, device=device)
    tb = sim.simulate("pt2pt_single", n_threads=4, theta=1,
                      part_bytes=s_part, ready=ready, engine=engine,
                      device=device)
    return tb.time_s / tp.time_s, tp.time_us


def rows(engine: str = ENGINE, device=DEVICE):
    theory = pm.eta_large(4, 1, GAMMA, 25e9)
    out = [("fig8/theory_eta", theory, "eq(4), gamma=100us/MB")]
    for s in SIZES:
        for ap in ("part", "pt2pt_many", "rma_single_passive"):
            g, us = gain(ap, s, engine, device)
            out.append((f"fig8/{ap}/{s}B_part", us,
                        f"gain={g:.2f} (theory {theory:.2f})"))
    return out


if __name__ == "__main__":
    import sys
    module_main(sys.modules[__name__])
