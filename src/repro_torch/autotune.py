"""Autotune command line of the port: the model picks a plan, the
simulator grades it.

  python -m repro_torch.autotune                     # every autotune scenario
  python -m repro_torch.autotune --scenario fft      # filter by key substring
  python -m repro_torch.autotune --scenario n_threads=4 --explain
  python -m repro_torch.autotune --top 5 --explain   # show runner-up plans
  python -m repro_torch.autotune --engine reference  # grade on the oracle
  python -m repro_torch.autotune --explain --device cpu

One row per scenario of the ``autotune`` sweep spec
(:mod:`repro_torch.experiments.specs`): the model's pick, its predicted
and simulated times, the simulated grid-best, and the regret.
``--explain`` prints the closed-form model's term-by-term reasoning for
each pick (and, with ``--top N``, the next-best candidates), so a
surprising choice can be traced to the term that drove it — the
contention term a VCI spread removes, the Pready chain aggregation
removes, or the drain phase nothing removes.  ``--engine`` selects the
fabric that grades the picks (``cuda``, the default, ``torch``,
``vector`` or ``reference``), ``--device`` where the torch and cuda
engines run (``cuda`` unless ``cpu`` is asked for).
"""

from __future__ import annotations

import argparse
import sys

from .core import planner as pl
from .core.simulator import ENGINES
from .experiments import SPECS, record_key
from .experiments.engine import autotune_desc

US = 1e-6


def _parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.autotune", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenario", default="",
                    help="substring filter on the scenario record key"
                         " (e.g. 'workload=fft' or 'n_threads=4')")
    ap.add_argument("--explain", action="store_true",
                    help="print the model's term breakdown per pick")
    ap.add_argument("--top", type=int, default=1,
                    help="with --explain, also show the next N-1 ranked"
                         " candidates")
    ap.add_argument("--engine", default="cuda", choices=ENGINES,
                    help="fabric engine grading the pick (default: cuda)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the torch and cuda engines")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse_args(argv)
    spec = SPECS["autotune"]
    points = [(record_key(p), p) for p in spec.points("full")]
    if args.scenario:
        points = [(k, p) for k, p in points if args.scenario in k]
        if not points:
            print(f"no scenario key contains {args.scenario!r}; keys:",
                  file=sys.stderr)
            for k, _ in ((record_key(p), p) for p in spec.points("full")):
                print(f"  {k}", file=sys.stderr)
            return 2
    worst = 0.0
    for key, params in points:
        desc = autotune_desc(params)
        ev = pl.evaluate_grid(desc, engine=args.engine, device=args.device)
        ch, best = ev.choice, ev.best
        worst = max(worst, ev.regret)
        print(f"{key}")
        print(f"  pick: {ch.approach} theta={ch.theta}"
              f" aggr_bytes={ch.aggr_bytes:g} n_vcis={ch.n_vcis}"
              f"  predicted {ch.predicted_us:.2f} us,"
              f" simulated {ev.auto_time_s / US:.2f} us")
        print(f"  grid-best: {best.approach} theta={best.theta}"
              f" aggr_bytes={best.aggr_bytes:g} n_vcis={best.n_vcis}"
              f"  simulated {ev.best_time_s / US:.2f} us"
              f"  -> regret {ev.regret:.3f}"
              f" ({ev.n_candidates} candidates)")
        if args.explain:
            for ranked in pl.rank_plans(desc)[:max(1, args.top)]:
                for line in pl.explain(desc, ranked).splitlines():
                    print(f"  | {line}")
    print(f"# worst regret: {worst:.3f} over {len(points)} scenarios")
    return 0


if __name__ == "__main__":
    sys.exit(main())
