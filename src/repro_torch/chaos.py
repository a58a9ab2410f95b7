"""Chaos-campaign command line of the port: randomized fault sweeps with
hard invariants.

A thin wrapper over :mod:`repro_torch.experiments.chaos`.  Samples
``n`` seeded campaigns (randomized fault specs x recovery policies x
stencil/serving scenarios), runs each on ``--engine`` (``cuda`` by
default) and on the scalar ``reference`` engine, and checks the
invariant set (engine agreement, message and hedge conservation,
monotone clocks, bounded retransmission rounds, determinism re-runs).
Exits 1 if any campaign violates an invariant.

    python -m repro_torch.chaos --campaigns 64 --seed 0 --out chaos.json
    python -m repro_torch.chaos --campaigns 32 --device cpu

``--device`` is where the torch and cuda engines run: ``cuda`` unless
``cpu`` is asked for; asking for the card without one exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys

from .core.fabric_torch import resolve_device
from .core.simulator import ENGINES
from .experiments.chaos import run_campaigns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.chaos",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--campaigns", type=int, default=64,
                    help="number of seeded campaigns (default 64)")
    ap.add_argument("--seed", type=int, default=0,
                    help="campaign seed root (default 0)")
    ap.add_argument("--out", default=None,
                    help="write the JSON report here")
    ap.add_argument("--verbose", action="store_true",
                    help="print one line per campaign")
    ap.add_argument("--engine", default="cuda", choices=ENGINES,
                    help="engine held against reference (default: cuda)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the torch and cuda engines")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"chaos: {e}", file=sys.stderr)
        return 2

    def progress(idx, info):
        if args.verbose:
            status = "FAIL" if info["violations"] else "ok"
            print(f"  campaign {idx:3d} [{status}] {info['kind']}"
                  f"/{info['policy']} retx={info['n_retransmits']}")

    report = run_campaigns(args.campaigns, seed=args.seed,
                           progress=progress, engine=args.engine,
                           device=device)
    report["device"] = str(device)
    print(f"chaos: {report['n_campaigns']} campaigns "
          f"(seed {report['seed']}, {report['n_serving']} serving, "
          f"{args.engine} on {device} vs reference), "
          f"policies {report['by_policy']}, "
          f"{report['n_violations']} violations")
    for v in report["violations"]:
        print(f"  VIOLATION: {v}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
        print(f"wrote {args.out}")
    return 1 if report["n_violations"] else 0


if __name__ == "__main__":
    sys.exit(main())
