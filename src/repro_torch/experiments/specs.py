"""The sweep-spec registry: Figs 4-8, the 1-D halo, steady state, the
stencil and weak-scaling tiers, load imbalance, serving, faults,
membership and recovery, each a declarative grid.

Copies of the JAX package's specs of the same names, so their records
carry the same keys as the committed golden baseline
(``BENCH_scenarios.json``); the planner's ``autotune`` and
``ir_passes`` wait for the port's planner (ROADMAP queue 1, item 5).
Every spec's ``smoke`` grid is a subset of its full grid.
``gain_vs_pt2pt_single < 1`` means slower than the bulk baseline,
``> 1`` means the scenario's pipelining wins.
"""

from __future__ import annotations

from typing import Dict, Mapping

from .engine import SweepSpec, parse_key

_CONTENTION_APPROACHES = ("pt2pt_single", "part", "pt2pt_many")

FIG4 = SweepSpec(
    name="fig4_latency",
    runner="oneshot",
    grid={"approach": ("pt2pt_single", "part", "part_old",
                       "rma_single_passive"),
          "part_bytes": (64, 4096, 65536, 1 << 20, 16 << 20)},
    fixed={"n_threads": 1, "theta": 1},
    smoke={"approach": ("pt2pt_single", "part"),
           "part_bytes": (64, 1 << 20)},
    baseline_approach="pt2pt_single",
    note="single-pair latency/bandwidth across the protocol switches",
)


FIG5 = SweepSpec(
    name="fig5_contention",
    runner="oneshot",
    grid={"approach": _CONTENTION_APPROACHES,
          "n_threads": (1, 2, 4, 8, 16, 32)},
    fixed={"theta": 1, "part_bytes": 64, "n_vcis": 1},
    smoke={"approach": _CONTENTION_APPROACHES, "n_threads": (32,)},
    baseline_approach="pt2pt_single",
    note="thread contention on one VCI: part/many collapse vs single",
)


FIG6 = SweepSpec(
    name="fig6_vci",
    runner="oneshot",
    grid={"approach": _CONTENTION_APPROACHES,
          "n_vcis": (1, 2, 4, 8, 16, 32)},
    fixed={"n_threads": 32, "theta": 1, "part_bytes": 64},
    smoke={"approach": _CONTENTION_APPROACHES, "n_vcis": (1, 32)},
    baseline_approach="pt2pt_single",
    note="VCIs recover the contention loss: crossover vs Fig 5",
)


FIG7 = SweepSpec(
    name="fig7_aggregation",
    runner="oneshot",
    grid={"approach": ("pt2pt_single", "part"),
          "aggr_bytes": (0, 2048, 16384)},
    fixed={"n_threads": 4, "theta": 32, "part_bytes": 64, "n_vcis": 1},
    smoke={"approach": ("pt2pt_single", "part"), "aggr_bytes": (0, 16384)},
    baseline_approach="pt2pt_single",
    note="message aggregation under MPIR_CVAR_PART_AGGR_SIZE",
)


FIG8 = SweepSpec(
    name="fig8_earlybird",
    runner="oneshot",
    grid={"approach": ("pt2pt_single", "part"),
          "gamma": (25.0, 50.0, 100.0, 250.0),
          "part_bytes": (1 << 20, 4 << 20)},
    fixed={"n_threads": 4, "theta": 1},
    smoke={"approach": ("pt2pt_single", "part"), "gamma": (100.0,),
           "part_bytes": (4 << 20,)},
    baseline_approach="pt2pt_single",
    note="early-bird overlap of a gamma-delayed last partition",
)


STEADY = SweepSpec(
    name="steady_state",
    runner="steady",
    grid={"approach": _CONTENTION_APPROACHES, "n_iters": (1, 16, 64)},
    fixed={"n_threads": 4, "theta": 8, "part_bytes": 8192, "n_vcis": 4,
           "aggr_bytes": 16384},
    smoke={"approach": ("pt2pt_single", "part"), "n_iters": (64,)},
    note="persistent-request amortization over iterations",
)


HALO1D = SweepSpec(
    name="halo1d",
    runner="halo",
    grid={"approach": _CONTENTION_APPROACHES, "n_ranks": (2, 4, 8, 16)},
    fixed={"theta": 4, "part_bytes": 4 << 20, "gamma": 250.0, "n_vcis": 2,
           "n_threads": 1},
    smoke={"approach": ("pt2pt_single", "part"), "n_ranks": (4,)},
    baseline_approach="pt2pt_single",
    note="1-D ring halo with a gamma-delayed boundary partition",
)

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

IMBALANCE = SweepSpec(
    name="imbalance",
    runner="imbalance",
    grid={"approach": ("pt2pt_single", "part"),
          "workload": ("fft", "stencil"), "theta": (4, 8)},
    fixed={"n_ranks": 8, "n_threads": 4, "part_bytes": 1 << 20, "seed": 0,
           "n_vcis": 2},
    smoke={"approach": ("pt2pt_single", "part"), "workload": ("stencil",),
           "theta": (4,)},
    baseline_approach="pt2pt_single",
    note="per-rank compute noise from the Appendix-A (eps, delta) model",
)


SERVING = SweepSpec(
    name="serving",
    runner="serving",
    grid={"approach": _CONTENTION_APPROACHES,
          "arrival": ("poisson", "bursty"),
          "rate_rps": (8000, 14000, 20000)},
    fixed={"n_requests": 256, "n_tenants": 4, "n_stages": 4, "theta": 8,
           "part_bytes": 131072, "n_vcis": 4, "aggr_bytes": 0,
           "compute_us": 40.0, "window_us": 5.0, "seed": 3},
    smoke={"approach": ("pt2pt_single", "part"), "arrival": ("poisson",),
           "rate_rps": (20000,)},
    baseline_approach="pt2pt_single",
    note="open-loop serving: seeded traces drive pipeline-parallel decode"
         " flows, tail latency (p50/p99/p999) + goodput vs offered load",
)


FAULTS = SweepSpec(
    name="faults",
    runner="faulty",
    grid={"approach": _CONTENTION_APPROACHES,
          "fault_rate": (0.0, 0.01, 0.02, 0.05)},
    fixed={"dims": (4, 4), "face_bytes": 131072, "theta": 8, "n_threads": 1,
           "n_vcis": 2, "timeout_us": 50.0, "fault_seed": 3},
    smoke={"approach": ("pt2pt_single", "part"), "fault_rate": (0.0, 0.02)},
    baseline_approach="pt2pt_single",
    tolerances={"n_retransmits": 0.0, "n_rounds": 0.0, "retrans_bytes": 0.0},
    note="goodput under seeded partition drops: the bulk message stakes"
         " every partition on one draw and resends the whole buffer, the"
         " partitioned plan resends only the lost chunks",
)


MEMBERSHIP = SweepSpec(
    name="membership",
    runner="membership",
    grid={"approach": ("pt2pt_single", "part"),
          "fail_at_us": (60.0, 100.0), "recover_at_us": (0.0, 180.0)},
    fixed={"n_ranks": 8, "model_parallel": 2, "fail_rank": 3,
           "theta": 8, "part_bytes": 16384, "n_threads": 1, "n_vcis": 2,
           "n_iters": 12, "detect_us": 100.0},
    smoke={"approach": ("part",), "fail_at_us": (60.0,),
           "recover_at_us": (0.0, 180.0)},
    tolerances={"n_events": 0.0, "plan_data": 0.0, "plan_dropped": 0.0,
                "grad_accum_factor": 0.0},
    note="elastic membership: a rank leaves (and optionally rejoins)"
         " mid-run, quiesce + plan_mesh re-plan + CommPlan re-agreement"
         " + cold-fabric warm-up all land on the measured clock",
)


SERVING_FAULTS = SweepSpec(
    name="serving_faults",
    runner="servingfaults",
    grid={"approach": ("pt2pt_single", "part"),
          "fault_rate": (0.005, 0.02)},
    fixed={"arrival": "bursty", "rate_rps": 14000, "n_requests": 96,
           "n_tenants": 4, "n_stages": 4, "theta": 8, "part_bytes": 131072,
           "n_vcis": 4, "aggr_bytes": 0, "compute_us": 40.0,
           "window_us": 5.0, "seed": 3, "timeout_us": 50.0, "fault_seed": 2},
    smoke={"approach": ("pt2pt_single", "part"), "fault_rate": (0.02,)},
    baseline_approach="pt2pt_single",
    tolerances={"n_retransmits": 0.0, "retrans_bytes": 0.0},
    note="serving tail under drops: whole-buffer retransmits inflate the"
         " bulk path's p99 several-fold while the partitioned path resends"
         " single chunks into the same queues",
)


RECOVERY = SweepSpec(
    name="recovery",
    runner="recovery",
    grid={"scenario": ("stencil", "serving", "shed"),
          "level": (0, 1)},
    fixed={"fault_seed": 3, "seed": 2},
    smoke={"scenario": ("stencil", "serving", "shed"),
           "level": (1,)},
    tolerances={"adaptive_kept": 0.0, "hedged_kept": 0.0,
                "n_retransmits": 0.0, "n_hedges": 0.0,
                "n_suppressed": 0.0, "n_shed": 0.0,
                "n_completed": 0.0},
    note="recovery policies vs the fixed retransmission clock:"
         " guarded adaptive RTO (<= fixed TTS on every stencil"
         " record), hedged retransmits (p999 cut at <= 2x duplicate"
         " bytes on faulty serving), and overload shedding (goodput"
         " plateau past saturation)",
)


SPECS: Dict[str, SweepSpec] = {
    s.name: s for s in (FIG4, FIG5, FIG6, FIG7, FIG8, STEADY, HALO1D,
                        STENCIL3D, WEAK_SCALING, WEAK_SCALING_XL,
                        WEAK_SCALING_XXL, IMBALANCE, SERVING, FAULTS,
                        MEMBERSHIP, SERVING_FAULTS, RECOVERY)
}


def contention_crossover(results: Mapping[str, Mapping[str, Mapping[str, float]]]
                         ) -> Dict[str, Dict[str, float]]:
    """Fig-5/Fig-6 crossover ratios from a results document.

    For each contended approach, the slowdown vs ``pt2pt_single`` at the
    smallest and largest VCI count present in the ``fig6_vci`` records:
    the paper's headline is >= ~10x at 1 VCI collapsing to ~1x (many) /
    a few x (part) at 32 VCIs.
    """
    recs = results.get("fig6_vci", {})
    by_vci: Dict[int, Dict[str, float]] = {}
    for key, metrics in recs.items():
        p = parse_key(key)
        by_vci.setdefault(int(p["n_vcis"]), {})[p["approach"]] = \
            metrics["time_us"]
    if not by_vci:
        return {}
    lo, hi = min(by_vci), max(by_vci)
    out: Dict[str, Dict[str, float]] = {}
    for ap in ("part", "pt2pt_many"):
        if ap in by_vci[lo] and ap in by_vci[hi]:
            out[ap] = {
                f"slowdown_at_{lo}_vcis":
                    by_vci[lo][ap] / by_vci[lo]["pt2pt_single"],
                f"slowdown_at_{hi}_vcis":
                    by_vci[hi][ap] / by_vci[hi]["pt2pt_single"],
            }
    return out
