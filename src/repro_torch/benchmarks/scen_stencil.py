"""N-D stencil scenario: Cartesian rank grids with anisotropic faces.

The 2-D/3-D generalization of ``scen_halo`` (Collom et al., "Persistent
and Partitioned MPI for Stencil Communication"): every rank exchanges one
face per neighbor over a torus, and the rank-local block is anisotropic,
so the per-dimension face payloads span orders of magnitude — here
2 KiB / 8 KiB / 128 KiB in 3-D, crossing the eager, bcopy and rendezvous
protocol switches within a single scenario step.
"""

from __future__ import annotations

import functools

from ..core import simulator as sim
from .common import DEVICE, ENGINE, module_main

APPROACHES = ("pt2pt_single", "part", "pt2pt_many")  # bulk baseline first
GRIDS = ((4, 4), (2, 2, 2), (4, 2, 2))  # 1-D lives in scen_halo
# Rank-local cells per dimension; trailing dims are thin so faces differ.
LOCAL = {2: (1024, 16), 3: (256, 64, 4)}
THETA, BYTES_PER_CELL, N_VCIS = 4, 8.0, 2


@functools.lru_cache(maxsize=None)
def _results(engine: str, device):
    out = []
    for dims in GRIDS:
        local = LOCAL[len(dims)]
        base = None
        for ap in APPROACHES:
            r = sim.simulate_stencil(ap, dims=dims, theta=THETA,
                                     local_shape=local,
                                     bytes_per_cell=BYTES_PER_CELL,
                                     n_vcis=N_VCIS, engine=engine,
                                     device=device)
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
        dims = "x".join(str(x) for x in d["dims"])
        faces = "/".join(str(int(b)) for b in d["face_bytes"])
        out.append((
            f"stencil/{d['approach']}/{dims}",
            d["time_us"],
            f"faces={faces}B,msgs={d['n_messages']},"
            f"gain={d['gain_vs_bulk']:.2f}",
        ))
    return out


if __name__ == "__main__":
    import sys
    module_main(sys.modules[__name__])
