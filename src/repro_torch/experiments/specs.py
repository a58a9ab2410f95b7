"""The stencil sweep specs: the 3-D torus and the weak-scaling tiers
from 512 to 32768 ranks, each a declarative grid.

Copies of the JAX package's specs of the same names, so their records
carry the same keys as the committed golden baseline
(``BENCH_scenarios.json``).  Every spec's ``smoke`` grid is a subset of
its full grid.  ``gain_vs_pt2pt_single < 1`` means slower than the bulk
baseline, ``> 1`` means the scenario's pipelining wins.
"""

from __future__ import annotations

from typing import Dict

from .engine import SweepSpec

_CONTENTION_APPROACHES = ("pt2pt_single", "part", "pt2pt_many")

STENCIL3D = SweepSpec(
    name="stencil3d",
    runner="stencil",
    grid={"approach": _CONTENTION_APPROACHES,
          "dims": ((2, 2, 2), (4, 2, 2))},
    fixed={"local_shape": (256, 64, 4), "bytes_per_cell": 8.0, "theta": 4,
           "n_threads": 1, "n_vcis": 2},
    smoke={"approach": ("pt2pt_single", "part"), "dims": ((2, 2, 2),)},
    baseline_approach="pt2pt_single",
    note="3-D torus, anisotropic block: face sizes 2 KiB / 8 KiB / 128 KiB"
         " span the eager/bcopy/rendezvous protocols",
)

WEAK_SCALING = SweepSpec(
    name="weak_scaling",
    runner="stencil",
    grid={"approach": _CONTENTION_APPROACHES,
          "dims": ((2, 2, 2), (4, 4, 4), (8, 8, 4), (8, 8, 8))},
    fixed={"local_shape": (64, 64, 64), "bytes_per_cell": 8.0, "theta": 4,
           "n_threads": 2, "n_vcis": 2},
    smoke={"approach": ("pt2pt_single", "part"), "dims": ((8, 8, 8),)},
    baseline_approach="pt2pt_single",
    note="weak scaling to a 512-rank periodic torus at a fixed 64^3 local"
         " block (32 KiB faces)",
)

WEAK_SCALING_XL = SweepSpec(
    name="weak_scaling_xl",
    runner="stencil",
    grid={"approach": _CONTENTION_APPROACHES,
          "dims": ((8, 8, 8), (16, 8, 8), (16, 16, 8), (16, 16, 16))},
    fixed={"local_shape": (64, 64, 64), "bytes_per_cell": 8.0, "theta": 4,
           "n_threads": 2, "n_vcis": 2},
    smoke={"approach": ("pt2pt_single", "part"), "dims": ((16, 16, 16),)},
    baseline_approach="pt2pt_single",
    note="XL weak scaling to a 4096-rank periodic torus (196k wire"
         " messages per partitioned record)",
)

WEAK_SCALING_XXL = SweepSpec(
    name="weak_scaling_xxl",
    runner="stencil",
    grid={"approach": _CONTENTION_APPROACHES,
          "dims": ((16, 16, 16), (32, 16, 16), (32, 32, 16), (32, 32, 32))},
    fixed={"local_shape": (64, 64, 64), "bytes_per_cell": 8.0, "theta": 4,
           "n_threads": 2, "n_vcis": 2},
    smoke={"approach": ("pt2pt_single", "part"), "dims": ((32, 32, 32),)},
    baseline_approach="pt2pt_single",
    note="XXL weak scaling to a 32768-rank periodic torus (~1.6M wire"
         " messages per partitioned record)",
)

SPECS: Dict[str, SweepSpec] = {s.name: s for s in (
    STENCIL3D, WEAK_SCALING, WEAK_SCALING_XL, WEAK_SCALING_XXL)}
