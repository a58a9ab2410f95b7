"""Shared helpers of the port's benchmark harness (one module per paper
table)."""

from __future__ import annotations

import argparse
import csv
import sys
from typing import Iterable, Tuple

from ..core.simulator import ENGINES

Row = Tuple[str, float, str]  # (name, us_per_call, derived)

SIZES_SMALL_TO_LARGE = [64, 256, 1024, 2048, 4096, 8192, 16384, 65536,
                        262144, 1 << 20, 4 << 20, 16 << 20]

# Where every module runs unless told otherwise: the hand-written kernel
# on the card.
ENGINE, DEVICE = "cuda", "cuda"


def emit(rows: Iterable[Row], header: bool = False) -> None:
    w = csv.writer(sys.stdout)
    if header:
        w.writerow(["name", "us_per_call", "derived"])
    for name, us, derived in rows:
        w.writerow([name, f"{us:.3f}", derived])
    sys.stdout.flush()


def add_engine_args(ap: argparse.ArgumentParser) -> None:
    """``--engine`` and ``--device``, as every entry point of the port
    takes them."""
    ap.add_argument("--engine", default=ENGINE, choices=ENGINES,
                    help=f"fabric engine (default: {ENGINE})")
    ap.add_argument("--device", default=DEVICE, choices=("cuda", "cpu"),
                    help="device of the torch and cuda engines"
                         f" (default: {DEVICE})")


def module_main(mod, argv=None) -> None:
    """A driver module run alone: its rows as CSV, or with ``--json``
    its scenario results as JSON."""
    import json
    ap = argparse.ArgumentParser(prog=f"python -m {mod.__name__}",
                                 description=(mod.__doc__ or "")
                                 .splitlines()[0])
    add_engine_args(ap)
    if hasattr(mod, "results"):
        ap.add_argument("--json", action="store_true",
                        help="print the scenario results as JSON")
    args = ap.parse_args(argv)
    kw = {"engine": args.engine, "device": args.device}
    if getattr(args, "json", False):
        print(json.dumps(mod.results(**kw), indent=2))
    else:
        emit(mod.rows(**kw))
