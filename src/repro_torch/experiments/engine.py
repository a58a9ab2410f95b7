"""Declarative sweep engine for the stencil specs: grid specs ->
deduplicated scenario runs -> records checked against the golden
baseline.

The port's counterpart of the JAX package's ``experiments/engine.py``,
for the ``stencil`` runner.  A :class:`SweepSpec` names the runner, a
parameter grid (cartesian product over approach x dims x ...), and an
optional reduced ``smoke`` grid.  The engine expands grids
deterministically, deduplicates points by a canonical record key, runs
the whole grid through the device path (:func:`run_records_batched`),
derives per-group gain metrics against a declared baseline approach,
and diffs records against a versioned golden-baseline document
(``BENCH_scenarios.json``) with :func:`compare_to_baseline`.

Records are keyed by the *full* parameter dict; the engine and device
are not part of the record key — every engine must reproduce the same
baseline records — but they do key the run cache.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from ..core import simulator as sim

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


# ---------------------------------------------------------------------------
# Runners
# ---------------------------------------------------------------------------

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


RUNNERS = {"stencil": run_stencil}

# Metric a spec's gain derives from, per runner.
PRIMARY_METRIC = {"stencil": "time_us"}


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
# and modes share results; engine and device key it so different
# engines' results never alias.
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


def run_records(runner: str, points: Sequence[Mapping[str, Any]],
                engine: str = DEFAULT_ENGINE, device="cuda"
                ) -> Dict[str, Dict[str, float]]:
    """Run deduplicated points through one runner; returns key -> metrics."""
    dev = str(sim.resolve_device(device))
    keyed: Dict[str, Dict[str, Any]] = {}
    for p in points:
        keyed.setdefault(record_key(p), dict(p))
    missing = [(k, p) for k, p in keyed.items()
               if (runner, k, engine, dev) not in _CACHE]
    if missing:
        batched = run_records_batched(runner, [p for _, p in missing],
                                      engine=engine, device=dev)
        if batched is not None:
            left = []
            for (k, p), metrics in zip(missing, batched):
                if metrics is None:
                    left.append((k, p))
                else:
                    _CACHE[(runner, k, engine, dev)] = metrics
            missing = left
    for k, p in missing:
        _CACHE[(runner, k, engine, dev)] = RUNNERS[runner](
            p, engine=engine, device=dev)
    return {k: dict(_CACHE[(runner, k, engine, dev)]) for k in keyed}


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
             engine: str = DEFAULT_ENGINE, device="cuda"
             ) -> Dict[str, Dict[str, float]]:
    """Run one spec's grid; returns sorted key -> metrics (incl. gains)."""
    points = spec.points(mode)
    keyed = {record_key(p): p for p in points}
    records = run_records(spec.runner, points, engine=engine, device=device)
    if spec.baseline_approach:
        _add_gains(spec, keyed, records)
    return dict(sorted(records.items()))


# ---------------------------------------------------------------------------
# Golden baselines
# ---------------------------------------------------------------------------

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
