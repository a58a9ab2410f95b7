"""Sweep command line of the port: run the stencil specs on the device
and check their records against the golden baseline.

  python -m repro_torch.sweep --smoke --check BENCH_scenarios.json
  python -m repro_torch.sweep --spec weak_scaling_xxl --smoke \\
      --engine cuda --check BENCH_scenarios.json
  python -m repro_torch.sweep --full --engine torch
  python -m repro_torch.sweep --smoke --engine vector --device cpu

``--check`` diffs the fresh records against a committed baseline and
exits 1 on any out-of-tolerance metric.  ``--engine`` selects the fabric
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
from .experiments import SPECS, compare_to_baseline, run_spec


def _parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sweep", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
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
    results = {}
    for name in names:
        t0 = time.perf_counter()
        results[name] = run_spec(SPECS[name], mode=mode, engine=args.engine,
                                 device=args.device)
        print(f"# {name}: {len(results[name])} records ({mode},"
              f" {args.engine} on {args.device})"
              f" in {time.perf_counter() - t0:.3f} s")
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
