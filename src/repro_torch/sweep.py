"""Sweep command line of the port: run the sweep specs on the device
and check their records against the golden baseline.

  python -m repro_torch.sweep --list
  python -m repro_torch.sweep --smoke --check BENCH_scenarios.json
  python -m repro_torch.sweep --spec weak_scaling_xxl --smoke \\
      --engine cuda --check BENCH_scenarios.json
  python -m repro_torch.sweep --full --spec fig5_contention,fig6_vci \\
      --engine torch --out results.json
  python -m repro_torch.sweep --smoke --engine vector --device cpu

``--list`` prints every registered spec with its runner, record counts
and description.  After the records, the Fig-5/Fig-6 crossover is
printed when ``fig6_vci`` ran.  ``--out`` writes the raw results as
JSON.  ``--check`` diffs the fresh records against a committed baseline
and exits 1 on any out-of-tolerance metric.  ``--engine`` selects the fabric
(``cuda``, the default: the hand-written kernels; ``torch``: torch
tensor scans; ``vector``/``reference``: the NumPy oracles), ``--device``
where the torch and cuda engines run (``cuda`` unless ``cpu`` is asked
for).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .core.simulator import ENGINES
from .experiments import (SPECS, compare_to_baseline, contention_crossover,
                          run_spec)


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
    ap.add_argument("--engine", default="cuda", choices=ENGINES,
                    help="fabric engine (default: cuda)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the torch and cuda engines")
    ap.add_argument("--out", default="",
                    help="write the raw results JSON to this path")
    ap.add_argument("--check", default="",
                    help="baseline JSON to diff against (exit 1 on drift)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse_args(argv)
    mode = "full" if args.full else "smoke"
    names = [n.strip() for n in args.specs.split(",") if n.strip()] \
        or list(SPECS)
    unknown = [n for n in names if n not in SPECS]
    if unknown:
        print(f"unknown specs {unknown}; have {sorted(SPECS)}",
              file=sys.stderr)
        return 2
    if args.list:
        for name in names:
            spec = SPECS[name]
            print(f"{spec.name:18s} {spec.runner:13s}"
                  f" {len(spec.points('full')):4d} records"
                  f" ({len(spec.points('smoke'))} smoke)  {spec.note}")
        return 0
    results = {}
    for name in names:
        t0 = time.perf_counter()
        results[name] = run_spec(SPECS[name], mode=mode, engine=args.engine,
                                 device=args.device)
        print(f"# {name}: {len(results[name])} records ({mode},"
              f" {args.engine} on {args.device})"
              f" in {time.perf_counter() - t0:.3f} s")
    for ap, ratios in contention_crossover(results).items():
        detail = ", ".join(f"{k}={v:.2f}x" for k, v in ratios.items())
        print(f"# crossover {ap} vs pt2pt_single: {detail}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"mode": mode, "engine": args.engine,
                       "device": args.device, "results": results}, f,
                      indent=2, sort_keys=True)
        print(f"# results written to {args.out}", file=sys.stderr)
    if args.check:
        try:
            with open(args.check) as f:
                doc = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError) as e:
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
