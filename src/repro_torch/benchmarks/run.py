"""Benchmark harness entry point of the port — one module per paper
table/figure, plus the post-paper scenario drivers (steady-state, halo,
N-D stencil, load imbalance, open-loop serving, faults).

    python -m repro_torch.benchmarks.run --fast --json out.json
    python -m repro_torch.benchmarks.run --fast --device cpu

Prints ``name,us_per_call,derived`` CSV, the same rows in the same order
as the JAX package's ``python -m benchmarks.run``.  ``--engine`` and
``--device`` select the fabric engine and where it runs (``cuda`` and
``cuda`` by default; asking for the card without one exits 2).
``--fast`` skips what runs outside the simulator: without it the
early-bird gradient-sync rows follow, from 8 gloo ranks on the CPU,
then the ``roofline_report`` rows of the dry run's artifacts
(``python -m repro_torch.launch.dryrun --all``), single pod then two
pods, or one ``roofline/NO_ARTIFACTS`` row.  ``--seed N`` threads a seed to
the imbalance scenario.  ``--json [PATH]`` also writes the scenario
results as a JSON document (default: benchmark_results.json).  Grid
sweeps with golden-baseline checking live in ``repro_torch.sweep``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List

from ..core.fabric_torch import resolve_device
from . import (earlybird, fig4_latency, fig5_congestion, fig6_vci,
               fig7_aggregation, fig8_earlybird, roofline_report,
               scen_faults, scen_halo, scen_imbalance, scen_serving,
               scen_steady, scen_stencil, tableA_delayrate)
from .common import DEVICE, ENGINE, Row, add_engine_args, emit

SCENARIOS = (scen_steady, scen_halo, scen_stencil, scen_imbalance,
             scen_serving, scen_faults)
MODULES = (tableA_delayrate, fig4_latency, fig5_congestion, fig6_vci,
           fig7_aggregation, fig8_earlybird, *SCENARIOS)


def _kw(mod, seed: int, engine: str, device) -> dict:
    kw = {"engine": engine, "device": device}
    if mod is scen_imbalance:
        kw["seed"] = seed
    return kw


def collect(seed: int = 0, engine: str = ENGINE, device=DEVICE
            ) -> List[Row]:
    """Every module's rows, in the order ``run`` prints them."""
    return [row for mod in MODULES
            for row in mod.rows(**_kw(mod, seed, engine, device))]


def scenario_results(seed: int = 0, engine: str = ENGINE,
                     device=DEVICE) -> dict:
    """The ``--json`` document: each scenario module's results."""
    return {mod.__name__.split(".")[-1]:
            mod.results(**_kw(mod, seed, engine, device))
            for mod in SCENARIOS}


def _seed(text: str) -> int:
    seed = int(text)
    if seed < 0:
        raise argparse.ArgumentTypeError("--seed needs a non-negative"
                                         " integer value")
    return seed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.run", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--fast", action="store_true",
                    help="only the simulator's rows (no gloo ranks)")
    ap.add_argument("--json", nargs="?", const="benchmark_results.json",
                    default="", metavar="PATH",
                    help="also write the scenario results as JSON")
    ap.add_argument("--seed", type=_seed, default=0,
                    help="seed of the imbalance scenario (default 0)")
    add_engine_args(ap)
    args = ap.parse_args(argv)
    try:
        device = str(resolve_device(args.device))
    except RuntimeError as e:
        print(f"benchmarks.run: {e}", file=sys.stderr)
        return 2
    emit([], header=True)
    for mod in MODULES:
        emit(mod.rows(**_kw(mod, args.seed, args.engine, device)))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(scenario_results(args.seed, args.engine, device), f,
                      indent=2)
        print(f"# scenario JSON written to {args.json}", file=sys.stderr)
    if not args.fast:
        emit(earlybird.rows())
        emit(roofline_report.rows())
        emit(roofline_report.rows("multi"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
