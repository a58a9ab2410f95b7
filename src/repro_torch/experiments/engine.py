"""Declarative sweep engine: grid specs -> deduplicated scenario runs
-> records checked against the golden baseline.

The port's counterpart of the JAX package's ``experiments/engine.py``.
A :class:`SweepSpec` names a runner (one of the simulator's scenario
drivers: ``oneshot`` for Figs 4-8, ``steady``, ``halo``, ``stencil``,
``imbalance``, ``serving``, ``autotune`` (the planner's closed loop),
``faulty``, ``membership``, ``servingfaults``, ``ir`` (the CommPlan IR's
pass pipeline) and ``recovery``), a parameter grid (cartesian
product over approach x dims x ...), and an optional reduced ``smoke``
grid.  The engine expands grids deterministically, deduplicates points
by a canonical record key, runs stencil grids through the whole-grid
device path (:func:`run_records_batched`) and every other point through
its runner (in spawned worker processes with ``jobs`` > 1), derives
per-group gain metrics against a declared baseline approach, writes
baseline documents (:func:`make_baseline`) and an opt-in run cache
(:func:`save_disk_cache`), and diffs records against a versioned
golden-baseline document (``BENCH_scenarios.json``) with
:func:`compare_to_baseline`.

Records are keyed by the *full* parameter dict; the engine and device
are not part of the record key — every engine must reproduce the same
baseline records — but they do key the run cache.
"""

from __future__ import annotations

import itertools
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from .. import compat
from ..core import commplan as cp
from ..core import faults as flt
from ..core import perfmodel as pm
from ..core import plan_ir as pir
from ..core import planner as pl
from ..core import simulator as sim
from ..core import topology as tp

BASELINE_VERSION = 1

DEFAULT_ENGINE = "cuda"

# Exact-match floor: |new - ref| <= tol_rel * |ref| + ABS_FLOOR.
ABS_FLOOR = 1e-9


# ---------------------------------------------------------------------------
# Record keys
# ---------------------------------------------------------------------------

def _fmt(v: Any) -> str:
    if isinstance(v, (tuple, list)):
        return "x".join(_fmt(x) for x in v)
    if isinstance(v, float) and v == int(v):
        return str(int(v))
    return str(v)


def record_key(params: Mapping[str, Any]) -> str:
    """Canonical ``k=v,...`` key over *all* params, sorted by name."""
    return ",".join(f"{k}={_fmt(params[k])}" for k in sorted(params))


def parse_key(key: str) -> Dict[str, str]:
    """Inverse of :func:`record_key` at the string level (values stay
    strings; grids are small enough that callers compare textually)."""
    return dict(kv.split("=", 1) for kv in key.split(","))


# ---------------------------------------------------------------------------
# Runners — one per simulator scenario driver.  Each takes a plain params
# dict, the engine and the device, and returns a flat {metric: float} dict.
# ---------------------------------------------------------------------------

def _gamma_ready(params: Mapping[str, Any]):
    gamma = params.get("gamma", 0.0)
    if not gamma:
        return None
    return sim.delayed_ready(params.get("n_threads", 1),
                             params.get("theta", 1),
                             params["part_bytes"], gamma)


def run_oneshot(params: Mapping[str, Any],
                engine: str = DEFAULT_ENGINE, device="cuda"
                ) -> Dict[str, float]:
    r = sim.simulate(params["approach"],
                     n_threads=params.get("n_threads", 1),
                     theta=params.get("theta", 1),
                     part_bytes=params["part_bytes"],
                     ready=_gamma_ready(params),
                     n_vcis=params.get("n_vcis", 1),
                     aggr_bytes=params.get("aggr_bytes", 0.0),
                     engine=engine, device=device)
    return {"time_us": r.time_us, "n_messages": float(r.n_messages)}


def run_steady(params: Mapping[str, Any],
               engine: str = DEFAULT_ENGINE, device="cuda"
               ) -> Dict[str, float]:
    r = sim.simulate_steady_state(params["approach"],
                                  n_iters=params["n_iters"],
                                  n_threads=params.get("n_threads", 1),
                                  theta=params.get("theta", 1),
                                  part_bytes=params["part_bytes"],
                                  ready=_gamma_ready(params),
                                  n_vcis=params.get("n_vcis", 1),
                                  aggr_bytes=params.get("aggr_bytes", 0.0),
                                  engine=engine, device=device)
    return {"amortized_us": r.amortized_s / sim.US,
            "steady_iter_us": r.steady_iter_s / sim.US,
            "setup_us": r.setup_s / sim.US,
            "n_messages": float(r.n_messages)}


def run_halo(params: Mapping[str, Any],
             engine: str = DEFAULT_ENGINE, device="cuda"
             ) -> Dict[str, float]:
    r = sim.simulate_halo(params["approach"],
                          n_ranks=params["n_ranks"],
                          theta=params.get("theta", 1),
                          part_bytes=params["part_bytes"],
                          n_threads=params.get("n_threads", 1),
                          ready=_gamma_ready(params),
                          n_vcis=params.get("n_vcis", 1),
                          aggr_bytes=params.get("aggr_bytes", 0.0),
                          periodic=params.get("periodic", True),
                          engine=engine, device=device)
    return {"time_us": r.time_us, "n_messages": float(r.n_messages)}


def run_imbalance(params: Mapping[str, Any],
                  engine: str = DEFAULT_ENGINE, device="cuda"
                  ) -> Dict[str, float]:
    r = sim.simulate_imbalance(params["approach"],
                               n_ranks=params["n_ranks"],
                               workload=pm.WORKLOADS[params["workload"]],
                               theta=params.get("theta", 1),
                               part_bytes=params["part_bytes"],
                               n_threads=params.get("n_threads", 1),
                               n_vcis=params.get("n_vcis", 1),
                               aggr_bytes=params.get("aggr_bytes", 0.0),
                               seed=params.get("seed", 0),
                               engine=engine, device=device)
    return {"time_us": r.time_us,
            "mean_delay_us": r.mean_delay_s / sim.US,
            "model_delay_us": r.model_delay_s / sim.US,
            "n_messages": float(r.n_messages)}


def run_serving(params: Mapping[str, Any],
                engine: str = DEFAULT_ENGINE, device="cuda"
                ) -> Dict[str, float]:
    """Open-loop serving: tail latency + goodput at one offered load.

    One record per (approach, arrival model, offered rate) point; the
    spec's load axis turns the records into a goodput-vs-offered-load
    and tail-latency-vs-load curve per approach.  Deterministic: the
    trace is a pure function of (arrival, rate, n, tenants, seed).
    """
    r = sim.simulate_serving(params["approach"],
                             arrival=params.get("arrival", "poisson"),
                             rate_rps=params["rate_rps"],
                             n_requests=params["n_requests"],
                             n_tenants=params.get("n_tenants", 1),
                             skew=params.get("skew", 0.0),
                             n_stages=params.get("n_stages", 4),
                             theta=params.get("theta", 1),
                             part_bytes=params["part_bytes"],
                             n_vcis=params.get("n_vcis", 1),
                             aggr_bytes=params.get("aggr_bytes", 0.0),
                             compute_us=params.get("compute_us", 0.0),
                             window_us=params.get("window_us", 5.0),
                             seed=params.get("seed", 0),
                             engine=engine, device=device)
    return {"p50_us": r.p50_s / sim.US,
            "p99_us": r.p99_s / sim.US,
            "p999_us": r.p999_s / sim.US,
            "mean_us": float(r.latency_s.mean()) / sim.US,
            "offered_rps": r.offered_rps,
            "goodput_rps": r.goodput_rps,
            "n_messages": float(r.n_messages)}


def _fault_spec(params: Mapping[str, Any]) -> flt.FaultSpec:
    """A sweep point's :class:`~repro_torch.core.faults.FaultSpec` from
    flat params — drops only; membership events are built by
    :func:`run_membership` from its own axes."""
    return flt.FaultSpec(drop_prob=params.get("fault_rate", 0.0),
                         timeout_us=params.get("timeout_us", 50.0),
                         backoff=params.get("backoff", 2.0),
                         max_retries=params.get("max_retries", 8),
                         seed=params.get("fault_seed", 0))


def run_faulty(params: Mapping[str, Any],
               engine: str = DEFAULT_ENGINE, device="cuda"
               ) -> Dict[str, float]:
    """Stencil exchange on a lossy fabric: goodput under retransmission.

    ``fault_rate`` is the per-partition drop probability; a
    ``fault_rate = 0`` point must reproduce the healthy stencil record
    bit-for-bit (the no-op gate, on all four engines).  The
    goodput metrics make the paper's trade-off quantitative on the
    robustness axis: the bulk message stakes every partition on one
    drop draw and resends the whole buffer, the partitioned plan
    resends only the lost chunks.
    """
    dims = tuple(params["dims"])
    r = sim.simulate_faulty(params["approach"],
                            faults=_fault_spec(params),
                            dims=dims,
                            periodic=params.get("periodic", True),
                            theta=params.get("theta", 1),
                            n_threads=params.get("n_threads", 1),
                            face_bytes=[params["face_bytes"]] * len(dims),
                            n_vcis=params.get("n_vcis", 1),
                            aggr_bytes=params.get("aggr_bytes", 0.0),
                            engine=engine, device=device)
    return {"tts_us": r.tts_s / sim.US,
            "clean_tts_us": r.clean_tts_s / sim.US,
            "recovery_us": r.recovery_s / sim.US,
            "goodput_gbps": r.goodput_bps / 1e9,
            "clean_goodput_gbps": r.clean_goodput_bps / 1e9,
            "n_retransmits": float(r.n_retransmits),
            "retrans_bytes": float(r.retrans_bytes),
            "n_rounds": float(r.rounds),
            "n_messages": float(r.n_messages)}


def run_membership(params: Mapping[str, Any],
                   engine: str = DEFAULT_ENGINE, device="cuda"
                   ) -> Dict[str, float]:
    """Elastic membership: rank leave (and optional rejoin) mid-run.

    One :class:`~repro_torch.core.faults.RankFailure` at ``fail_at_us``
    (``recover_at_us`` > 0 adds the rejoin); the record pins the full
    re-agreement bill — quiesce, the ``plan_mesh`` re-plan
    (``runtime/elastic.py``) plus CommPlan rebuild, and the measured cold-fabric warm-up — next
    to the steady iteration it interrupts.
    """
    recover = params.get("recover_at_us", 0.0)
    failures = (flt.RankFailure(params.get("fail_rank", 0),
                                t_fail_us=params["fail_at_us"],
                                t_recover_us=recover or None),)
    r = sim.simulate_membership(params["approach"],
                                n_ranks=params["n_ranks"],
                                theta=params.get("theta", 1),
                                part_bytes=params["part_bytes"],
                                faults=flt.FaultSpec(failures=failures),
                                n_iters=params["n_iters"],
                                n_threads=params.get("n_threads", 1),
                                n_vcis=params.get("n_vcis", 1),
                                aggr_bytes=params.get("aggr_bytes", 0.0),
                                model_parallel=params.get(
                                    "model_parallel", 1),
                                target_data=params.get("target_data"),
                                detect_us=params.get("detect_us", 100.0),
                                engine=engine, device=device)
    return {"tts_us": r.tts_s / sim.US,
            "steady_iter_us": r.steady_iter_s / sim.US,
            "post_iter_us": r.post_iter_s / sim.US,
            "reagree_us": r.reagree_s / sim.US,
            "quiesce_us": r.quiesce_s / sim.US,
            "replan_us": r.replan_s / sim.US,
            "warmup_us": r.warmup_s / sim.US,
            "n_events": float(r.n_events),
            "plan_data": float(r.plan_data),
            "plan_dropped": float(r.plan_dropped),
            "grad_accum_factor": float(r.grad_accum_factor),
            "n_messages": float(r.n_messages)}


def run_servingfaults(params: Mapping[str, Any],
                      engine: str = DEFAULT_ENGINE, device="cuda"
                      ) -> Dict[str, float]:
    """Serving tail latency under partition drops.

    Runs the identical trace with and without the fault spec and records
    the p99 inflation — what retransmission queue contention costs the
    tail at one offered load.
    """
    kw = dict(arrival=params.get("arrival", "poisson"),
              rate_rps=params["rate_rps"],
              n_requests=params["n_requests"],
              n_tenants=params.get("n_tenants", 1),
              skew=params.get("skew", 0.0),
              n_stages=params.get("n_stages", 4),
              theta=params.get("theta", 1),
              part_bytes=params["part_bytes"],
              n_vcis=params.get("n_vcis", 1),
              aggr_bytes=params.get("aggr_bytes", 0.0),
              compute_us=params.get("compute_us", 0.0),
              window_us=params.get("window_us", 5.0),
              seed=params.get("seed", 0),
              engine=engine, device=device)
    fr = sim.simulate_serving(params["approach"],
                              faults=_fault_spec(params), **kw)
    cr = sim.simulate_serving(params["approach"], **kw)
    return {"p99_us": fr.p99_s / sim.US,
            "p99_clean_us": cr.p99_s / sim.US,
            "p99_inflation": fr.p99_s / cr.p99_s,
            "mean_us": float(fr.latency_s.mean()) / sim.US,
            "goodput_rps": fr.goodput_rps,
            "clean_goodput_rps": cr.goodput_rps,
            "n_retransmits": float(fr.n_retransmits),
            "retrans_bytes": float(fr.retrans_bytes),
            "n_messages": float(fr.n_messages)}


def autotune_desc(params: Mapping[str, Any]) -> pl.ScenarioDesc:
    """A sweep point's scenario description for the planner.

    ``workload`` is a :data:`repro_torch.core.perfmodel.WORKLOADS` name or
    ``"none"`` (no compute ramp, nothing to overlap).
    """
    name = params.get("workload", "none")
    workload = None if name == "none" else pm.WORKLOADS[name]
    return pl.ScenarioDesc(total_bytes=float(params["total_bytes"]),
                           n_threads=params.get("n_threads", 1),
                           workload=workload,
                           max_parts=params.get("max_parts", 512),
                           max_vcis=params.get("max_vcis", 32))


def run_autotune(params: Mapping[str, Any],
                 engine: str = DEFAULT_ENGINE, device="cuda"
                 ) -> Dict[str, float]:
    """The closed loop: the model picks a plan, the simulator grades it.

    Simulates the model's pick *and* every candidate of the search grid
    and records the regret (auto / grid-best simulated time) plus the
    chosen parameters — so the committed baseline pins both the model's
    decisions and how good they are.  Everything is deterministic and
    engine-independent (the fabrics are bit-for-bit identical).
    """
    ev = pl.evaluate_grid(autotune_desc(params), engine=engine,
                          device=device)
    ch = ev.choice
    return {"auto_time_us": ev.auto_time_s / sim.US,
            "best_time_us": ev.best_time_s / sim.US,
            "regret": ev.regret,
            "predicted_us": ch.predicted_us,
            "chosen_approach_idx": float(
                pl.PLANNER_APPROACHES.index(ch.approach)),
            "chosen_theta": float(ch.theta),
            "chosen_aggr_bytes": float(ch.aggr_bytes),
            "chosen_n_vcis": float(ch.n_vcis),
            "n_candidates": float(ev.n_candidates),
            "n_messages": float(ev.auto_messages)}


def _ir_module(params: Mapping[str, Any], faults):
    """Raise one ``ir_passes`` scenario with its *pointwise* plans: every
    flow class planned by ``plan_auto`` in isolation — the exact baseline
    the pass pipeline must beat (or match)."""
    scenario = params["scenario"]
    n_vcis = int(params.get("n_vcis", 2))
    if scenario == "stencil3d":
        dims = tuple(params.get("dims", (2, 2, 2)))
        local_shape = tuple(params.get("local_shape", (16, 16, 16)))
        topo = tp.CartTopology.create(dims, True)
        halo = tp.HaloSpec.create(topo, local_shape,
                                  params.get("bytes_per_cell", 8.0), 1)
        dim_plans = {}
        for d, b in enumerate(halo.all_face_bytes()):
            _, ch = cp.plan_auto(float(b), n_threads=1, max_vcis=n_vcis,
                                 faults=faults)
            dim_plans[d] = (ch.theta, ch.aggr_bytes, ch.n_vcis)
        return pir.raise_stencil(
            "part", dims=dims, local_shape=local_shape,
            bytes_per_cell=params.get("bytes_per_cell", 8.0),
            theta=1, n_vcis=n_vcis, dim_plans=dim_plans)
    if scenario == "faults":
        dims = tuple(params.get("dims", (4, 4)))
        fb = float(params.get("face_bytes", 131072.0))
        dim_plans = {}
        for d in range(len(dims)):
            _, ch = cp.plan_auto(fb, n_threads=1, max_vcis=n_vcis,
                                 faults=faults)
            dim_plans[d] = (ch.theta, ch.aggr_bytes, ch.n_vcis)
        return pir.raise_stencil(
            "part", dims=dims, face_bytes=[fb] * len(dims), theta=1,
            n_vcis=n_vcis, dim_plans=dim_plans)
    if scenario == "serving":
        theta = int(params.get("theta", 8))
        part_bytes = float(params.get("part_bytes", 131072.0))
        _, ch = cp.plan_auto(theta * part_bytes, n_threads=1,
                             max_vcis=n_vcis, faults=faults)
        return pir.raise_serving_wave(
            "part", arrival=params.get("arrival", "bursty"),
            rate_rps=params.get("rate_rps", 14000.0),
            n_requests=params.get("n_requests", 96),
            n_tenants=params.get("n_tenants", 4),
            skew=params.get("skew", 1.0),
            n_stages=params.get("n_stages", 4), theta=theta,
            part_bytes=part_bytes, n_vcis=n_vcis,
            compute_us=params.get("compute_us", 40.0),
            seed=params.get("seed", 3),
            plan_spec=(ch.theta, ch.aggr_bytes, ch.n_vcis))
    raise ValueError(f"unknown ir scenario {scenario!r}")


def run_ir(params: Mapping[str, Any],
           engine: str = DEFAULT_ENGINE, device="cuda"
           ) -> Dict[str, float]:
    """IR pass pipeline vs pointwise ``plan_auto`` on a multi-flow
    scenario — the closed loop for the cross-flow optimizer.

    The scenario is raised into :mod:`repro_torch.core.plan_ir` with every
    flow class planned by ``plan_auto`` in isolation (the pointwise
    baseline), then the default guarded pass pipeline rewrites it and
    both modules run on the same fabric engine.  The pipeline's
    measured guard makes ``ir_us <= pointwise_us`` hold by
    construction — a record where it doesn't is a pipeline bug, which
    is exactly why the ratio is pinned in the golden baseline.
    ``fault_rate > 0`` prices and runs both modules on the lossy fabric
    (retransmission traffic included).
    """
    dev = sim.resolve_device(device)
    faults = None
    if params["scenario"] == "faults" \
            and params.get("fault_rate", 0.0) > 0.0:
        faults = _fault_spec(params)
    mod = _ir_module(params, faults)
    base = pir.execute(mod, engine=engine, device=dev, faults=faults)
    pipe = pir.default_pipeline(engine=engine, device=dev)
    opt = pipe.run(mod, faults=faults)
    res = pir.execute(opt, engine=engine, device=dev, faults=faults)
    return {"pointwise_us": base.tts_s / sim.US,
            "ir_us": res.tts_s / sim.US,
            "ir_gain": base.tts_s / res.tts_s,
            "n_flows": float(base.n_flows),
            "n_wire_pointwise": float(base.n_wire),
            "n_wire_ir": float(res.n_wire),
            "n_passes_applied": float(len(pipe.applied)),
            "n_retransmits": float(res.n_retransmits),
            "n_messages": float(res.n_messages)}


# The recovery spec's scenario table: per (scenario, level) the
# parameters that differ, over shared bases below.  Levels are fault /
# load intensities; the *timeouts are deliberately mistuned* (above the
# 50us default) — the paper-level point of the adaptive policy is that
# a fixed clock tuned for one fabric is wrong on another.
_RECOVERY_LEVELS = {
    ("stencil", 0): dict(fault_rate=0.02, timeout_us=80.0),
    ("stencil", 1): dict(fault_rate=0.05, timeout_us=150.0),
    ("serving", 0): dict(fault_rate=0.01, timeout_us=100.0),
    ("serving", 1): dict(fault_rate=0.02, timeout_us=150.0),
    ("shed", 0): dict(rate_rps=120000.0),
    ("shed", 1): dict(rate_rps=240000.0),
}


def run_recovery(params: Mapping[str, Any],
                 engine: str = DEFAULT_ENGINE, device="cuda"
                 ) -> Dict[str, float]:
    """Recovery policies vs the fixed clock, guarded keep-only-if-better.

    Three scenarios, selected by ``scenario`` at intensity ``level``
    (:data:`_RECOVERY_LEVELS`):

    * ``stencil`` — :func:`simulate_faulty` under drops with a mistuned
      fixed timeout vs the adaptive per-link RTO.  The committed metric
      ``adaptive_tts_us`` is *guarded*: the runner simulates both
      policies and keeps the adaptive result only when it is no worse
      (``adaptive_kept``), the same discipline as the IR pipeline's
      measured guard — so ``adaptive_tts_us <= fixed_tts_us`` holds on
      every record by construction, and ``adaptive_raw_tts_us`` records
      what the estimator actually did.
    * ``serving`` — faulty open-loop serving, fixed vs hedged.  Guarded
      on two conditions: the hedged p999 must not exceed the fixed one
      AND the hedged bytes on the wire (retransmissions + suppressed
      duplicates) must stay within 2x the fixed policy's
      retransmission bytes (``dup_ratio``).
    * ``shed`` — overload protection past saturation: the same offered
      load with and without per-tenant depth caps + deadline shedding.
      The committed records pin the plateau (bounded ``shed_p99_us``,
      held ``shed_goodput_rps``) against the unprotected p99
      divergence.
    """
    scenario = params["scenario"]
    lvl = _RECOVERY_LEVELS[(scenario, int(params["level"]))]
    if scenario == "stencil":
        spec = flt.FaultSpec(drop_prob=lvl["fault_rate"],
                             timeout_us=lvl["timeout_us"],
                             seed=params.get("fault_seed", 3))
        kw = dict(dims=(4, 4), theta=8, face_bytes=[131072.0] * 2,
                  n_vcis=2, engine=engine, device=device)
        fixed = sim.simulate_faulty("part", faults=spec, policy="fixed",
                                    **kw)
        adapt = sim.simulate_faulty("part", faults=spec,
                                    policy="adaptive", **kw)
        kept = adapt.tts_s <= fixed.tts_s
        tts = adapt.tts_s if kept else fixed.tts_s
        return {"fixed_tts_us": fixed.tts_s / sim.US,
                "adaptive_raw_tts_us": adapt.tts_s / sim.US,
                "adaptive_tts_us": tts / sim.US,
                "adaptive_gain": fixed.tts_s / tts,
                "adaptive_kept": float(kept),
                "clean_tts_us": fixed.clean_tts_s / sim.US,
                "n_retransmits": float(fixed.n_retransmits),
                "n_messages": float(fixed.n_messages)}
    if scenario == "serving":
        spec = flt.FaultSpec(drop_prob=lvl["fault_rate"],
                             timeout_us=lvl["timeout_us"],
                             seed=params.get("fault_seed", 2))
        kw = dict(arrival="poisson", rate_rps=8000.0, n_requests=96,
                  n_tenants=4, skew=0.3, theta=8, part_bytes=16384.0,
                  n_vcis=4, compute_us=2.0, seed=params.get("seed", 2),
                  faults=spec, engine=engine, device=device)
        fixed = sim.simulate_serving("part", policy="fixed", **kw)
        hedged = sim.simulate_serving("part", policy="hedged", **kw)
        sent = hedged.retrans_bytes + hedged.duplicate_bytes
        ratio = sent / max(fixed.retrans_bytes, 1.0)
        kept = hedged.p999_s <= fixed.p999_s and ratio <= 2.0
        p999 = hedged.p999_s if kept else fixed.p999_s
        return {"fixed_p999_us": fixed.p999_s / sim.US,
                "hedged_raw_p999_us": hedged.p999_s / sim.US,
                "hedged_p999_us": p999 / sim.US,
                "hedged_gain": fixed.p999_s / p999,
                "hedged_kept": float(kept),
                "dup_ratio": ratio,
                "n_hedges": float(hedged.n_hedges),
                "n_suppressed": float(hedged.n_suppressed),
                "duplicate_bytes": float(hedged.duplicate_bytes),
                "n_retransmits": float(fixed.n_retransmits),
                "n_messages": float(fixed.n_messages)}
    if scenario == "shed":
        kw = dict(arrival="poisson", rate_rps=lvl["rate_rps"],
                  n_requests=128, n_tenants=2, theta=8,
                  part_bytes=32768.0, n_vcis=2, compute_us=2.0,
                  seed=params.get("seed", 0), engine=engine, device=device)
        base = sim.simulate_serving("part", **kw)
        shed = sim.simulate_serving("part", queue_depth=6,
                                    deadline_us=300.0, **kw)
        return {"base_p99_us": base.p99_s / sim.US,
                "shed_p99_us": shed.p99_s / sim.US,
                "base_goodput_rps": base.goodput_rps,
                "shed_goodput_rps": shed.goodput_rps,
                "goodput_retention": shed.goodput_retention,
                "n_shed": float(shed.n_shed),
                "n_completed": float(shed.completed),
                "offered_rps": base.offered_rps,
                "n_messages": float(base.n_messages)}
    raise ValueError(f"unknown recovery scenario {scenario!r}")


def _stencil_sim_kwargs(params: Mapping[str, Any]) -> Dict[str, Any]:
    """A stencil sweep point's :func:`simulate_stencil` kwargs — shared
    by the per-point runner and the whole-grid path so both evaluate the
    identical scenario."""
    return dict(approach=params["approach"],
                dims=tuple(params["dims"]),
                periodic=params.get("periodic", True),
                theta=params.get("theta", 1),
                n_threads=params.get("n_threads", 1),
                local_shape=tuple(params["local_shape"]),
                bytes_per_cell=params.get("bytes_per_cell", 8.0),
                halo_width=params.get("halo_width", 1),
                n_vcis=params.get("n_vcis", 1),
                aggr_bytes=params.get("aggr_bytes", 0.0))


def _stencil_metrics(r) -> Dict[str, float]:
    return {"time_us": r.time_us, "n_messages": float(r.n_messages),
            "face_bytes_min": min(r.face_bytes),
            "face_bytes_max": max(r.face_bytes)}


def run_stencil(params: Mapping[str, Any], engine: str = DEFAULT_ENGINE,
                device="cuda") -> Dict[str, float]:
    return _stencil_metrics(sim.simulate_stencil(
        engine=engine, device=device, **_stencil_sim_kwargs(params)))


RUNNERS = {
    "oneshot": run_oneshot,
    "steady": run_steady,
    "halo": run_halo,
    "stencil": run_stencil,
    "imbalance": run_imbalance,
    "serving": run_serving,
    "autotune": run_autotune,
    "faulty": run_faulty,
    "membership": run_membership,
    "servingfaults": run_servingfaults,
    "ir": run_ir,
    "recovery": run_recovery,
}

# Metric a spec's gain derives from, per runner.
PRIMARY_METRIC = {
    "oneshot": "time_us",
    "steady": "steady_iter_us",
    "halo": "time_us",
    "stencil": "time_us",
    "imbalance": "time_us",
    "serving": "p99_us",
    "autotune": "auto_time_us",
    "faulty": "tts_us",
    "membership": "tts_us",
    "servingfaults": "p99_us",
    "ir": "ir_us",
    "recovery": "adaptive_tts_us",
}


def _run_point(arg: Tuple[str, Mapping[str, Any], str, str]
               ) -> Dict[str, float]:
    """One point through its runner: ``(runner, params, engine,
    device)``.  Top level, so a process pool can pickle the work."""
    runner, params, engine, device = arg
    return RUNNERS[runner](params, engine=engine, device=device)


def _run_point_in_mode(arg: Tuple[bool, tuple]) -> Dict[str, float]:
    """:func:`_run_point` in a worker, under the parent's precision mode
    (``(x64, point)``): a spawned worker starts in the default mode."""
    x64, point = arg
    with compat.x64_mode(x64):
        return _run_point(point)


def _cache_device(dev: str) -> str:
    """The run cache's device entry: the device, marked ``/float32`` in
    the engines' float32 mode, whose records are not float64's."""
    return dev if compat.x64_enabled() else f"{dev}/float32"


# ---------------------------------------------------------------------------
# Specs and the engine
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SweepSpec:
    """One declarative sweep: a runner, a grid, and baseline tolerances.

    ``grid`` axes are swept as a cartesian product and merged over
    ``fixed``; ``smoke`` (optional) is a reduced grid whose expansion is
    a subset of the full grid's.  ``baseline_approach`` derives a
    ``gain_vs_<approach>`` metric within each group of points differing
    only in ``approach``.
    """
    name: str
    runner: str
    grid: Mapping[str, Sequence[Any]]
    fixed: Mapping[str, Any] = field(default_factory=dict)
    smoke: Optional[Mapping[str, Sequence[Any]]] = None
    baseline_approach: Optional[str] = None
    tol_rel: float = 0.02
    tolerances: Mapping[str, float] = field(default_factory=dict)
    note: str = ""

    def __post_init__(self):
        if self.runner not in RUNNERS:
            raise ValueError(f"unknown runner {self.runner!r}")

    def points(self, mode: str = "full") -> List[Dict[str, Any]]:
        """Expand the grid (or smoke sub-grid) into full param dicts."""
        if mode not in ("full", "smoke"):
            raise ValueError(f"mode must be 'full' or 'smoke', got {mode!r}")
        grid = self.grid if mode == "full" else (self.smoke or self.grid)
        axes = sorted(grid)
        out = []
        for combo in itertools.product(*(grid[k] for k in axes)):
            p = dict(self.fixed)
            p.update(zip(axes, combo))
            out.append(p)
        return out


# Process-wide run cache: (runner, record_key, engine, device) ->
# metrics.  Scenario runs are pure functions of their params, so specs
# and modes share results; engine and device (with the precision mode:
# :func:`_cache_device`) key it so different engines' results never
# alias.
_CACHE: Dict[Tuple[str, str, str, str], Dict[str, float]] = {}


def run_records_batched(runner: str, points: Sequence[Mapping[str, Any]],
                        engine: str = DEFAULT_ENGINE, device="cuda"
                        ) -> Optional[List[Optional[Dict[str, float]]]]:
    """Whole-grid evaluation of a stencil grid on the device.

    On the torch and cuda engines, stencil-runner grids stack all their
    points into stamped intent-batch columns and run through
    :func:`repro_torch.core.simulator.simulate_stencil_grid` (torch: one
    batched pipeline per rank-grid shape; cuda: one kernel super-batch
    with device-side finish reductions) instead of one Python-driven
    fabric per record.  Returns one metrics dict per point, with None
    for points the batched path cannot evaluate (dependent-traffic
    schedules) — the caller runs those per point — or None wholesale
    when the (runner, engine) pair has no batched path at all.
    """
    if engine not in sim.GRID_ENGINES or runner != "stencil":
        return None
    results = sim.simulate_stencil_grid(
        [_stencil_sim_kwargs(p) for p in points], engine=engine,
        device=device)
    return [None if r is None else _stencil_metrics(r) for r in results]


class WorkerPool:
    """``jobs`` worker processes that run :func:`_run_point`, started at
    the first :meth:`map` and shared by every run inside one ``with``
    block, so a sweep of many specs pays the workers' start-up once.

    The workers are spawned, never forked: CUDA cannot run in a forked
    child of a process that has touched the card.  On the card the
    parent builds the fabric kernel before a map, so each worker only
    loads the library from the build directory."""

    def __init__(self, jobs: int):
        self.jobs, self._ex = jobs, None

    def map(self, args: List[tuple]) -> List[Dict[str, float]]:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        if any(a[2] == "cuda" and a[3].startswith("cuda") for a in args):
            from ..kernels import build
            build.build(["fabric_scan"])
        if self._ex is None:
            self._ex = ProcessPoolExecutor(
                max_workers=self.jobs,
                mp_context=multiprocessing.get_context("spawn"))
        x64 = compat.x64_enabled()
        return list(self._ex.map(_run_point_in_mode,
                                 [(x64, a) for a in args]))

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        if self._ex is not None:
            self._ex.shutdown()
            self._ex = None


def run_records(runner: str, points: Sequence[Mapping[str, Any]],
                engine: str = DEFAULT_ENGINE, device="cuda", jobs: int = 1,
                pool: Optional[WorkerPool] = None
                ) -> Dict[str, Dict[str, float]]:
    """Run deduplicated points through one runner; returns key -> metrics.

    Stencil grids take the whole-grid path in this process; with
    ``jobs`` > 1 the remaining points run in ``pool`` (a
    :class:`WorkerPool` of its own when none is given)."""
    dev = str(sim.resolve_device(device))
    cdev = _cache_device(dev)
    keyed: Dict[str, Dict[str, Any]] = {}
    for p in points:
        keyed.setdefault(record_key(p), dict(p))
    missing = [(k, p) for k, p in keyed.items()
               if (runner, k, engine, cdev) not in _CACHE]
    if missing:
        batched = run_records_batched(runner, [p for _, p in missing],
                                      engine=engine, device=dev)
        if batched is not None:
            left = []
            for (k, p), metrics in zip(missing, batched):
                if metrics is None:
                    left.append((k, p))
                else:
                    _CACHE[(runner, k, engine, cdev)] = metrics
            missing = left
    args = [(runner, p, engine, dev) for _, p in missing]
    if jobs > 1 and len(missing) > 1:
        if pool is None:
            with WorkerPool(jobs) as own:
                done = own.map(args)
        else:
            done = pool.map(args)
    else:
        done = [_run_point(a) for a in args]
    for (k, _), metrics in zip(missing, done):
        _CACHE[(runner, k, engine, cdev)] = metrics
    return {k: dict(_CACHE[(runner, k, engine, cdev)]) for k in keyed}


# ---------------------------------------------------------------------------
# Persistent run cache (opt-in)
# ---------------------------------------------------------------------------

# The port's cache document: records by device, engine, runner and
# record key, with the baseline version they were made under.
CACHE_FORMAT = "repro_torch run cache"


def load_disk_cache(path: str) -> int:
    """Seed the process cache from a cache file written by
    :func:`save_disk_cache`; returns the entries loaded.  A file that
    is missing, unreadable, malformed, of another format or of another
    baseline version loads nothing: the cache only ever skips re-running
    pure functions, so dropping it is always safe."""
    try:
        with open(path) as f:
            doc = json.load(f)
        if doc.get("format") != CACHE_FORMAT \
                or doc.get("baseline_version") != BASELINE_VERSION:
            return 0
        loaded = {}
        for device, engines in doc.get("records", {}).items():
            for engine, runners in engines.items():
                for runner, recs in runners.items():
                    if runner not in RUNNERS:
                        continue
                    for key, metrics in recs.items():
                        loaded[(runner, key, engine, device)] = {
                            m: float(v) for m, v in metrics.items()}
    except (OSError, json.JSONDecodeError, TypeError, ValueError,
            AttributeError):
        return 0  # nothing was seeded above: all or nothing
    n = 0
    for k, metrics in loaded.items():
        if k not in _CACHE:
            _CACHE[k] = metrics
            n += 1
    return n


def save_disk_cache(path: str) -> int:
    """Write the process cache to ``path``; returns the entries written.

    The write is atomic: the document goes to a temporary file in the
    target's directory, which is then ``os.replace``-d over ``path``, so
    a crash (or a concurrent run) never leaves a truncated cache:
    readers see the old whole file or the new one."""
    records: Dict[str, Dict[str, Dict[str, Dict[str, Dict[str, float]]]]] \
        = {}
    for runner, key, engine, device in sorted(
            _CACHE, key=lambda k: (k[3], k[2], k[0], k[1])):
        records.setdefault(device, {}).setdefault(engine, {}).setdefault(
            runner, {})[key] = _CACHE[(runner, key, engine, device)]
    doc = {"format": CACHE_FORMAT, "baseline_version": BASELINE_VERSION,
           "records": records}
    path = os.path.abspath(path)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return len(_CACHE)


def _add_gains(spec: SweepSpec, keyed: Mapping[str, Dict[str, Any]],
               records: Dict[str, Dict[str, float]]) -> None:
    metric = PRIMARY_METRIC[spec.runner]
    gain_name = f"gain_vs_{spec.baseline_approach}"
    base_time: Dict[str, float] = {}
    for key, params in keyed.items():
        if params.get("approach") == spec.baseline_approach:
            group = record_key({k: v for k, v in params.items()
                                if k != "approach"})
            base_time[group] = records[key][metric]
    for key, params in keyed.items():
        group = record_key({k: v for k, v in params.items()
                            if k != "approach"})
        if group in base_time:
            records[key][gain_name] = base_time[group] / records[key][metric]


def run_spec(spec: SweepSpec, mode: str = "full",
             engine: str = DEFAULT_ENGINE, device="cuda", jobs: int = 1,
             pool: Optional[WorkerPool] = None
             ) -> Dict[str, Dict[str, float]]:
    """Run one spec's grid; returns sorted key -> metrics (incl. gains)."""
    points = spec.points(mode)
    keyed = {record_key(p): p for p in points}
    records = run_records(spec.runner, points, engine=engine, device=device,
                          jobs=jobs, pool=pool)
    if spec.baseline_approach:
        _add_gains(spec, keyed, records)
    return dict(sorted(records.items()))


def run_specs(specs: Sequence[SweepSpec], mode: str = "full",
              engine: str = DEFAULT_ENGINE, device="cuda", jobs: int = 1
              ) -> Dict[str, Dict[str, Dict[str, float]]]:
    """:func:`run_spec` over ``specs``, one worker pool shared by all
    of them; returns name -> records."""
    with WorkerPool(jobs) as pool:
        return {spec.name: run_spec(spec, mode=mode, engine=engine,
                                    device=device, jobs=jobs, pool=pool)
                for spec in specs}


# ---------------------------------------------------------------------------
# Golden baselines
# ---------------------------------------------------------------------------

def make_baseline(specs: Sequence[SweepSpec],
                  results: Mapping[str, Mapping[str, Mapping[str, float]]]
                  ) -> dict:
    """A versioned baseline document with per-metric tolerances recorded
    next to the values, so the checker needs no code-side configuration
    (the JAX package's layout; ``generator`` names the port's command)."""
    doc: dict = {
        "version": BASELINE_VERSION,
        "generator": "python -m repro_torch.sweep --update",
        "specs": {},
    }
    for spec in specs:
        doc["specs"][spec.name] = {
            "runner": spec.runner,
            "tol_rel": spec.tol_rel,
            "tolerances": {"n_messages": 0.0, **dict(spec.tolerances)},
            "records": {k: dict(m) for k, m in results[spec.name].items()},
        }
    return doc


def compare_to_baseline(
        doc: Mapping[str, Any],
        results: Mapping[str, Mapping[str, Mapping[str, float]]]
) -> List[str]:
    """Diff fresh results against a baseline document.

    Every metric of every fresh record must exist in the baseline and
    agree within the baseline's recorded tolerance.  Returns violations
    as readable strings (empty list = pass).  Results may cover a subset
    of the baseline's records (smoke mode); extra baseline records are
    not an error.
    """
    violations: List[str] = []
    if doc.get("version") != BASELINE_VERSION:
        violations.append(
            f"baseline version {doc.get('version')!r} != {BASELINE_VERSION}")
        return violations
    for name, res in results.items():
        bspec = doc.get("specs", {}).get(name)
        if bspec is None:
            violations.append(f"{name}: spec missing from baseline")
            continue
        default_tol = bspec.get("tol_rel", 0.02)
        tols = bspec.get("tolerances", {})
        for key, metrics in res.items():
            ref = bspec.get("records", {}).get(key)
            if ref is None:
                violations.append(f"{name}/{key}: record missing from"
                                  " baseline")
                continue
            for metric, value in metrics.items():
                if metric not in ref:
                    violations.append(
                        f"{name}/{key}: metric {metric!r} missing from"
                        " baseline")
                    continue
                tol = tols.get(metric, default_tol)
                ref_v = ref[metric]
                if abs(value - ref_v) > tol * abs(ref_v) + ABS_FLOOR:
                    violations.append(
                        f"{name}/{key}: {metric}={value:.6g} vs baseline"
                        f" {ref_v:.6g} (tol_rel={tol})")
    return violations
