"""Sweep command line of the port: run the sweep specs on the device,
check their records against the golden baseline, write baselines and
run caches, and measure the engines' throughput.

  python -m repro_torch.sweep --list
  python -m repro_torch.sweep --smoke --check BENCH_scenarios.json
  python -m repro_torch.sweep --spec weak_scaling_xxl --smoke \\
      --engine cuda --check BENCH_scenarios.json
  python -m repro_torch.sweep --full --spec fig5_contention,fig6_vci \\
      --engine torch --out results.json
  python -m repro_torch.sweep --smoke --engine vector --device cpu
  python -m repro_torch.sweep --full --jobs 4 --check BENCH_scenarios.json
  python -m repro_torch.sweep --full --cache .sweep_cache.json
  python -m repro_torch.sweep --update baseline_torch.json
  python -m repro_torch.sweep --bench-engine --smoke \\
      --bench-engines vector,torch,cuda \\
      --bench-check BENCH_engine_torch.json            # throughput gate
  python -m repro_torch.sweep --bench-engine --full \\
      --bench-out BENCH_engine_torch.json              # regenerate it
  python -m repro_torch.sweep --profile --specs weak_scaling_xxl --smoke

``--list`` prints every registered spec with its runner, record counts
and description.  After the records, the Fig-5/Fig-6 crossover is
printed when ``fig6_vci`` ran.  ``--out`` writes the raw results as
JSON.  ``--check`` diffs the fresh records against a committed baseline
and exits 1 on any out-of-tolerance metric.  ``--engine`` selects the
fabric (``cuda``, the default: the hand-written kernels; ``torch``:
torch tensor scans; ``vector``/``reference``: the NumPy oracles),
``--device`` where the torch and cuda engines run (``cuda`` unless
``cpu`` is asked for).

``--jobs N`` runs every point outside the whole-grid stencil path in N
spawned worker processes, one pool for the whole run.  ``--cache PATH``
names an opt-in JSON run cache (keyed by device, engine, runner, record
key and baseline version), loaded before the run and saved after it.  ``--update PATH``
runs the full grids and writes a baseline document; with ``--specs`` it
merges the selected specs into an existing baseline of the same version
and refuses (exit 2) without one.  ``--update``, ``--bench-out`` and
``--cache`` refuse (exit 2) to write the JAX package's documents
``BENCH_scenarios.json`` and ``BENCH_engine.json``.

``--bench-engine`` measures engine throughput instead of records (it
cannot be combined with ``--update``, ``--check``, ``--out``,
``--cache`` or ``--profile``): per spec and engine (``--bench-engines``
restricts the set) the best wall time of three cold runs, the events a
second (wire messages simulated a second of wall time) and the fabric
kernel's launches, written to ``--bench-out`` when given.  The
document names the device it was measured on (the card's
``nvidia-smi`` name and power limit, or ``cpu``) and the engines'
precision mode (``"x64"``: ``repro_torch.compat.x64_enabled()``, as
the reference records ``jax_enable_x64``; a document without the key
predates the float32 mode and was measured in float64).
``--bench-check`` gates against a committed document of the same device
and mode (exit 2 if either differs): the per-spec speedups of each ``BENCH_PAIRS`` pair
measured in both, and a >2x relative slowdown fails (exit 1).
``BENCH_SPEC_ENGINES`` restricts the 32768-rank XXL tier to the torch
and cuda engines.

``--profile`` runs the selected specs twice under cProfile, the first
pass cold (run cache and memos cleared), the second with the run cache
cleared but the memos warm, and prints the hottest functions, both
walls and the memo counters.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from . import compat
from .core import fabric_cuda, fabric_torch
from .core import simulator as sim
from .core.simulator import ENGINES
from .experiments import (SPECS, compare_to_baseline, contention_crossover,
                          load_disk_cache, make_baseline, run_spec,
                          save_disk_cache)
from .experiments import engine as _engine_mod

REPO = Path(__file__).resolve().parents[2]
# The JAX package's documents, which the port never rewrites.
REFERENCE_DOCUMENTS = ("BENCH_scenarios.json", "BENCH_engine.json")

BENCH_ENGINES = ("vector", "reference", "torch", "cuda")
BENCH_VERSION = 1
# Engine pairs whose same-run throughput ratio the regression gate
# tracks: (numerator, denominator).  Both engines of a pair run in the
# same process on the same machine.
BENCH_PAIRS = (("vector", "reference"), ("torch", "vector"),
               ("cuda", "torch"))
# The 32k-rank XXL tier takes minutes a record on the NumPy engines, so
# its bench cells are measured on the device engines only; a pair's
# speedup sums over the specs where both of its engines have cells.
BENCH_SPEC_ENGINES = {"weak_scaling_xxl": ("torch", "cuda")}
# Runners whose wall time measures orchestration (the planner's
# candidate grids, serving's admission loop, fault rounds, the IR's
# guard simulations), not fabric throughput.
BENCH_EXCLUDED_RUNNERS = ("autotune", "serving", "faulty", "membership",
                          "servingfaults", "ir", "recovery")
# Grids below this many wire messages are timer noise to the gate.
BENCH_MIN_EVENTS = 5000
BENCH_REGRESSION_FACTOR = 2.0


def _parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sweep", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--list", action="store_true",
                    help="print every registered spec with its runner and"
                         " one-line description, then exit")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--smoke", action="store_true",
                      help="run the reduced smoke grids (default)")
    mode.add_argument("--full", action="store_true",
                      help="run the full grids")
    ap.add_argument("--spec", "--specs", dest="specs", default="",
                    help="comma-separated spec names (default: all of "
                         + ", ".join(SPECS) + ")")
    ap.add_argument("--jobs", type=int, default=1,
                    help="spawned worker processes for the points outside"
                         " the whole-grid stencil path")
    ap.add_argument("--engine", default="cuda", choices=ENGINES,
                    help="fabric engine (default: cuda)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the torch and cuda engines")
    ap.add_argument("--cache", default="",
                    help="persistent JSON run cache: load before running,"
                         " save after (opt-in)")
    ap.add_argument("--out", default="",
                    help="write the raw results JSON to this path")
    ap.add_argument("--check", default="",
                    help="baseline JSON to diff against (exit 1 on drift)")
    ap.add_argument("--update", default="",
                    help="run the full grids and (re)write this baseline"
                         " JSON")
    ap.add_argument("--bench-engine", action="store_true",
                    help="measure engine throughput (events/sec, wall time"
                         " and kernel launches per spec and engine)"
                         " instead of records")
    ap.add_argument("--bench-engines", default=",".join(BENCH_ENGINES),
                    help="comma-separated engines to measure with"
                         " --bench-engine")
    ap.add_argument("--bench-out", default="",
                    help="write the throughput document to this path")
    ap.add_argument("--bench-check", default="",
                    help="committed throughput document to gate against"
                         " (exit 1 on a >2x relative slowdown)")
    ap.add_argument("--profile", action="store_true",
                    help="run the selected specs under cProfile, cold then"
                         " warm, and print the hottest functions and the"
                         " memo counters")
    ap.add_argument("--profile-top", type=int, default=20,
                    help="rows of cProfile output with --profile")
    return ap.parse_args(argv)


def _select_specs(names_arg: str):
    names = [n.strip() for n in names_arg.split(",") if n.strip()] \
        or list(SPECS)
    unknown = [n for n in names if n not in SPECS]
    if unknown:
        print(f"unknown specs {unknown}; have {sorted(SPECS)}",
              file=sys.stderr)
        return None
    return [SPECS[n] for n in names]


def is_reference_document(path: str) -> bool:
    """Whether ``path`` resolves to one of the JAX package's committed
    documents at the root of this checkout."""
    target = Path(path).resolve()
    return any(target == (REPO / name).resolve()
               for name in REFERENCE_DOCUMENTS)


def describe_device(device) -> str:
    """What a throughput document was measured on: ``cpu``, or the
    card's name and power limit as ``nvidia-smi`` gives them (the power
    limit sets the card's clocks under load)."""
    dev = sim.resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    if out:
        return out[0].strip()
    import torch
    return f"{torch.cuda.get_device_name(dev)}, power limit not read"


# ---------------------------------------------------------------------------
# --bench-engine
# ---------------------------------------------------------------------------

def _cold() -> None:
    """Drop the run cache and every memo, so the next run is real."""
    _engine_mod._CACHE.clear()
    sim.clear_merge_memo()


def _bench_entry(spec, mode: str, engine: str, device,
                 repeats: int = 3) -> dict:
    """One (spec, engine, mode) cell: the best wall time of ``repeats``
    cold runs (scheduler noise only ever slows a run down), events a
    second, and the fabric kernel's launches in one run.  The clock is
    read once ``run_spec`` has returned its records as host floats, so
    the card has finished the run."""
    wall = float("inf")
    for _ in range(repeats):
        _cold()
        before = fabric_cuda.LAUNCHES["fabric_scan"]
        t0 = time.perf_counter()
        records = run_spec(spec, mode=mode, engine=engine, device=device)
        wall = min(wall, time.perf_counter() - t0)
        launches = fabric_cuda.LAUNCHES["fabric_scan"] - before
    events = sum(m.get("n_messages", 0.0) for m in records.values())
    return {
        "spec": spec.name, "engine": engine, "mode": mode,
        "records": len(records), "events": int(events),
        "wall_s": wall, "launches": launches,
        "events_per_sec": events / wall if wall > 0 else 0.0,
    }


def run_bench_engine(specs, mode: str, engines=BENCH_ENGINES,
                     device="cuda", repeats: int = 3) -> dict:
    """The throughput document: every (spec, engine) cell.

    Smoke runs measure the smoke grids only; full runs measure both
    modes, so the document carries entries for either kind of later
    check.  Totals and the printed speedups are over the last mode's
    entries."""
    name = describe_device(device)
    modes = ("smoke",) if mode == "smoke" else ("smoke", "full")
    entries = []
    for m in modes:
        for engine in engines:
            for spec in specs:
                allowed = BENCH_SPEC_ENGINES.get(spec.name, BENCH_ENGINES)
                if engine not in allowed:
                    print(f"# bench {spec.name:18s} {engine:9s} {m:5s} "
                          f"   skipped (engines: {', '.join(allowed)})"
                          f"  [{name}]")
                    continue
                e = _bench_entry(spec, m, engine, device, repeats)
                entries.append(e)
                print(f"# bench {e['spec']:18s} {engine:9s} {m:5s} "
                      f"{e['wall_s'] * 1e3:9.1f} ms  {e['events']:8d} events"
                      f"  {e['events_per_sec'] / 1e3:9.1f} kev/s"
                      f"  launches {e['launches']}  [{name}]")
    totals = {}
    total_mode = modes[-1]
    cells = {(e["spec"], e["engine"]): e for e in entries
             if e["mode"] == total_mode}
    for engine in engines:
        es = [e for e in entries
              if e["engine"] == engine and e["mode"] == total_mode]
        totals[engine] = {"wall_s": sum(e["wall_s"] for e in es),
                          "events": sum(e["events"] for e in es)}
    for num, den in BENCH_PAIRS:
        common = [s.name for s in specs
                  if (s.name, num) in cells and (s.name, den) in cells]
        num_wall = sum(cells[(s, num)]["wall_s"] for s in common)
        den_wall = sum(cells[(s, den)]["wall_s"] for s in common)
        if not common or num_wall <= 0:
            continue
        speedup = den_wall / num_wall
        totals[f"speedup_{num}_vs_{den}"] = speedup
        print(f"# bench total ({total_mode}, {len(common)} specs): {den}"
              f" {den_wall:.3f}s vs {num} {num_wall:.3f}s"
              f" ({speedup:.1f}x)  [{name}]")
    _cold()  # leave no half-measured state behind
    return {"version": BENCH_VERSION, "mode": mode, "device": name,
            "x64": compat.x64_enabled(), "entries": entries,
            "totals": totals}


def _speedup_by_spec(doc: dict, mode: str, num: str, den: str) -> dict:
    """Per-spec ``num``-vs-``den`` events/sec ratio for one mode."""
    cells = {(e["spec"], e["engine"]): e for e in doc.get("entries", [])
             if e.get("mode") == mode}
    out = {}
    for (spec, engine), e in cells.items():
        ref = cells.get((spec, den))
        if engine != num or ref is None \
                or min(e["events"], ref["events"]) < BENCH_MIN_EVENTS \
                or ref["events_per_sec"] <= 0:
            continue
        out[spec] = e["events_per_sec"] / ref["events_per_sec"]
    return out


def check_bench_regression(doc: dict, ref: dict) -> list:
    """>2x regressions of any engine pair's per-spec speedup.

    Both engines of a :data:`BENCH_PAIRS` pair are measured in one run
    on one machine, so the compared quantity (the pair's events-a-second
    ratio) holds like against like; a pair is gated only where the fresh
    document measured both of its engines, and specs under
    ``BENCH_MIN_EVENTS`` events are exempt.  A host engine against a
    card engine is not like against like across devices, nor float32
    against float64, so documents of different devices or precision
    modes raise ``ValueError``.
    """
    if doc.get("device") != ref.get("device"):
        raise ValueError(f"throughput measured on {doc.get('device')!r},"
                         f" the committed document on"
                         f" {ref.get('device')!r}")
    if doc.get("x64", True) != ref.get("x64", True):
        raise ValueError(f"throughput measured with x64="
                         f"{doc.get('x64', True)}, the committed document"
                         f" with x64={ref.get('x64', True)}")
    violations = []
    for num, den in BENCH_PAIRS:
        for mode in ("smoke", "full"):
            measured = _speedup_by_spec(doc, mode, num, den)
            committed = _speedup_by_spec(ref, mode, num, den)
            for spec, want in committed.items():
                have = measured.get(spec)
                if have is not None \
                        and have * BENCH_REGRESSION_FACTOR < want:
                    violations.append(
                        f"{spec}/{mode}: {num} engine {have:.2f}x the"
                        f" {den} engine vs committed {want:.2f}x"
                        f" (>{BENCH_REGRESSION_FACTOR}x relative slowdown)")
    return violations


def _bench_main(args, specs, mode: str) -> int:
    clash = [f for f in ("update", "check", "out", "cache", "profile")
             if getattr(args, f)]
    if clash:
        print("--bench-engine measures throughput only; it cannot be"
              f" combined with {', '.join('--' + f for f in clash)}",
              file=sys.stderr)
        return 2
    engines = tuple(e.strip() for e in args.bench_engines.split(",")
                    if e.strip())
    unknown = [e for e in engines if e not in BENCH_ENGINES]
    if unknown:
        print(f"unknown --bench-engines {unknown};"
              f" have {list(BENCH_ENGINES)}", file=sys.stderr)
        return 2
    ref = None
    if args.bench_check:
        try:
            with open(args.bench_check) as f:
                ref = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"# cannot read bench baseline {args.bench_check}: {e}",
                  file=sys.stderr)
            return 2
    skipped = [s.name for s in specs if s.runner in BENCH_EXCLUDED_RUNNERS]
    if skipped:
        print(f"# bench excludes {', '.join(skipped)} (runner wall time"
              " measures orchestration overhead, not fabric throughput)",
              file=sys.stderr)
    specs = [s for s in specs if s.runner not in BENCH_EXCLUDED_RUNNERS]
    doc = run_bench_engine(specs, mode, engines, device=args.device)
    if ref is not None:
        try:
            violations = check_bench_regression(doc, ref)
        except ValueError as e:
            print(f"# cannot compare: {e}", file=sys.stderr)
            return 2
        if violations:
            print(f"# ENGINE THROUGHPUT REGRESSION"
                  f" ({len(violations)} violations):", file=sys.stderr)
            for v in violations:
                print(f"#   {v}", file=sys.stderr)
            return 1
        print("# engine throughput check passed")
    if args.bench_out:
        with open(args.bench_out, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"# throughput document written to {args.bench_out}",
              file=sys.stderr)
    return 0


# ---------------------------------------------------------------------------
# --profile
# ---------------------------------------------------------------------------

def memo_stats(engine: str) -> dict:
    """The memo counters ``--profile`` prints: the merge-order memo on
    every engine, the grid-point and stage-layout memos on the torch and
    cuda engines, and the cuda engine's operand memos."""
    out = {"merge": sim.merge_memo_stats()}
    if engine in sim.GRID_ENGINES:
        out["grid"] = sim.grid_memo_stats()
        out["layout"] = fabric_torch.layout_memo_stats()
    if engine == "cuda":
        out.update({f"cuda {k}": v
                    for k, v in fabric_cuda.memo_stats().items()})
    return out


def profile_specs(specs, mode: str, engine: str, device, jobs: int = 1,
                  top: int = 20, stream=None):
    """Run ``specs`` twice under cProfile: cold (run cache and memos
    cleared), then warm (run cache cleared, memos kept: what the
    memoization buys repeated evaluations).  Prints the ``top`` hottest
    functions to ``stream`` when given; returns the first pass's
    results and ``{"cold_s", "warm_s", "launches", "memos"}``, the
    launches being the fabric kernel's over both passes."""
    import cProfile
    import pstats
    _cold()
    before = fabric_cuda.LAUNCHES["fabric_scan"]
    profiler = cProfile.Profile()
    with _engine_mod.WorkerPool(jobs) as pool:
        t0 = time.perf_counter()
        profiler.enable()
        results = {s.name: run_spec(s, mode=mode, engine=engine,
                                    device=device, jobs=jobs, pool=pool)
                   for s in specs}
        t_cold = time.perf_counter() - t0
        _engine_mod._CACHE.clear()
        t0 = time.perf_counter()
        for s in specs:
            run_spec(s, mode=mode, engine=engine, device=device, jobs=jobs,
                     pool=pool)
        t_warm = time.perf_counter() - t0
        profiler.disable()
    if stream is not None:
        stats = pstats.Stats(profiler, stream=stream)
        stats.strip_dirs().sort_stats("cumulative")
        print(f"# cProfile, top {top} by cumulative time (both passes):",
              file=stream)
        stats.print_stats(top)
    return results, {"cold_s": t_cold, "warm_s": t_warm,
                     "launches": fabric_cuda.LAUNCHES["fabric_scan"]
                     - before, "memos": memo_stats(engine)}


def print_profile(prof: dict, stream) -> None:
    """``--profile``'s memo lines."""
    st = prof["memos"]["merge"]
    print(f"# merge-layout memo: pass 1 (cold) {prof['cold_s']:.3f}s ->"
          f" pass 2 (warm) {prof['warm_s']:.3f}s;"
          f" {st['hits']} hits, {st['misses']} misses,"
          f" {st['evictions']} evictions,"
          f" {st['messages_saved']} message re-sorts avoided", file=stream)
    if "grid" in prof["memos"]:
        g, lay = prof["memos"]["grid"], prof["memos"]["layout"]
        print(f"# grid-point memo: {g['hits']} hits, {g['misses']} misses,"
              f" {g['evictions']} evictions; stage-layout memo:"
              f" {lay['hits']} hits, {lay['misses']} misses,"
              f" {lay['evictions']} evictions", file=stream)
    for name, ps in prof["memos"].items():
        if name.startswith("cuda "):
            print(f"# {name} memo: {ps['hits']} hits, {ps['misses']}"
                  f" misses, {ps['evictions']} evictions"
                  f" ({ps['size']}/{ps['cap']} resident)", file=stream)
    print(f"# fabric_scan launches over both passes: {prof['launches']}",
          file=stream)


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    args = _parse_args(argv)
    mode = "full" if (args.full or args.update) else "smoke"
    specs = _select_specs(args.specs)
    if specs is None:
        return 2
    if args.list:
        for spec in specs:
            print(f"{spec.name:18s} {spec.runner:13s}"
                  f" {len(spec.points('full')):4d} records"
                  f" ({len(spec.points('smoke'))} smoke)  {spec.note}")
        return 0
    for flag in ("update", "bench_out", "cache"):
        path = getattr(args, flag)
        if path and is_reference_document(path):
            print(f"--{flag.replace('_', '-')} {path}: the JAX package's"
                  " document is never rewritten by the port; name a file"
                  " of the port's own", file=sys.stderr)
            return 2
    if args.jobs < 1:
        print(f"--jobs must be at least 1, got {args.jobs}", file=sys.stderr)
        return 2

    if args.bench_engine:
        return _bench_main(args, specs, mode)

    if args.cache:
        n = load_disk_cache(args.cache)
        if n:
            print(f"# loaded {n} cached records from {args.cache}",
                  file=sys.stderr)

    where = f"{args.engine} on {args.device}"
    if args.profile:
        results, prof = profile_specs(specs, mode, args.engine, args.device,
                                      args.jobs, args.profile_top,
                                      stream=sys.stderr)
        print_profile(prof, sys.stderr)
        for name, recs in results.items():
            print(f"# {name}: {len(recs)} records ({mode}, {where})")
    else:
        results = {}
        with _engine_mod.WorkerPool(args.jobs) as pool:
            for spec in specs:
                t0 = time.perf_counter()
                results[spec.name] = run_spec(
                    spec, mode=mode, engine=args.engine, device=args.device,
                    jobs=args.jobs, pool=pool)
                print(f"# {spec.name}: {len(results[spec.name])} records"
                      f" ({mode}, {where}) in"
                      f" {time.perf_counter() - t0:.3f} s")
    for ap, ratios in contention_crossover(results).items():
        detail = ", ".join(f"{k}={v:.2f}x" for k, v in ratios.items())
        print(f"# crossover {ap} vs pt2pt_single: {detail}")

    if args.cache:
        save_disk_cache(args.cache)
        print(f"# run cache saved to {args.cache}", file=sys.stderr)

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"mode": mode, "engine": args.engine,
                       "device": args.device, "results": results}, f,
                      indent=2, sort_keys=True)
        print(f"# results written to {args.out}", file=sys.stderr)

    if args.update:
        doc = make_baseline(specs, results)
        if args.specs:
            # a partial update merges into the existing document
            try:
                with open(args.update) as f:
                    old = json.load(f)
            except (OSError, json.JSONDecodeError):
                old = None
            if not isinstance(old, dict) \
                    or old.get("version") != doc["version"]:
                print("--update with --specs needs an existing baseline of"
                      " the same version to merge into; run a full --update"
                      " first", file=sys.stderr)
                return 2
            doc["specs"] = {**old["specs"], **doc["specs"]}
        with open(args.update, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"# baseline written to {args.update}", file=sys.stderr)

    if args.check:
        try:
            with open(args.check) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"# cannot read baseline {args.check}: {e}",
                  file=sys.stderr)
            return 2
        violations = compare_to_baseline(doc, results)
        if violations:
            print(f"# BASELINE DRIFT ({len(violations)} violations):",
                  file=sys.stderr)
            for v in violations:
                print(f"#   {v}", file=sys.stderr)
            return 1
        n = sum(len(r) for r in results.values())
        print(f"# baseline check passed: {n} records within tolerance")
    return 0


if __name__ == "__main__":
    sys.exit(main())
