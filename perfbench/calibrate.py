"""The readings the limits are set from, on the chip at a cell's size.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,... \\
        --control-seeds 1,2,3 [--fault-seeds 4,5,6] [--seconds 15] \\
        [--out FILE]

In one process (set-up is paid once): for every seed the program's
numbers against the plain reference (the lower readings), for every
control seed the control's (the reference in the precision below the
one the configuration states: TF32 for a training cell's f32, fp8 for
a served cell's bf16), and for a training cell, for every fault seed,
those of the program with half of each batch left out; and for a
training cell the readings its family's ``calibrate_train`` gives, where
it has one (``families/granite_moe.py``: ``router_margins``).  One JSON
line a reading, to standard output and to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _half_batch_step(cfg, scfg, *, seq_len, batch, device):
    """The port's train step on the first half of each batch's rows: the
    mean taken over the rest (a fault the check must catch)."""
    from perfbench.cells import _default_train_step
    inner = _default_train_step(cfg, scfg, seq_len=seq_len,
                                batch=batch // 2, device=device)

    def step(state, b):
        state, loss = inner(state, {k: v[:batch // 2] for k, v in b.items()})
        step.log = inner.log
        return state, loss
    step.log = inner.log
    return step


def _norms(readings: dict) -> dict:
    """Readings without the slices' samples (tensors), for a JSON line."""
    if "program" in readings:
        return {k: _norms(v) for k, v in readings.items()}
    return {k: v for k, v in readings.items() if not k.endswith("_s")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 perfbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from perfbench import cells, harness
    from perfbench.families import family
    from perfbench.sizes import sizes
    from perfbench.traffic.gen import PrefillStream
    bench = json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
    spec = harness.cell_spec(bench, args.workload)
    s, mix = sizes(spec["conf"]), spec["mix"]
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = bool(mix["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(mix["tf32"])
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps({"workload": args.workload, **rec})
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    def seeds(text):
        return [int(x) for x in text.split(",") if x]
    train = mix["kind"] == "train"
    hook = getattr(family(s.family), "calibrate_train", lambda *a: {})
    ctrl, fault = set(seeds(args.control_seeds)), seeds(args.fault_seeds)
    for seed in seeds(args.seeds):
        t = time.perf_counter()
        if train:
            run = harness.run_cell(spec, seed, 0.0, False, dev, t)
            emit({"seed": seed, "what": "program", **run.numbers,
                  "losses": run.notes["losses"],
                  "ref_losses": run.notes["ref_losses"],
                  "s": time.perf_counter() - t,
                  "readings": _norms(run.readings)})
            for what, rec in hook(s, seed, mix, dev).items():
                emit({"seed": seed, "what": what, **rec})
            if seed in ctrl:
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True
                tf32 = cells.reference_train(s, mix, seed, dev)
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
                emit({"seed": seed, "what": "control_tf32",
                      **cells.train_numbers(tf32, run.readings["reference"]),
                      "losses": tf32["losses"], "readings": _norms(tf32)})
        else:
            run = harness.run_cell(spec, seed, args.seconds, False, dev, t)
            emit({"seed": seed, "what": "program", **run.numbers,
                  "requests": run.notes["checked_requests"],
                  "batches": run.notes["checked_batches"],
                  **run.end_to_end, "s": time.perf_counter() - t,
                  "readings": run.readings})
            if seed in ctrl:
                stream = PrefillStream(mix, seed, s.token_ids)
                picked = run.notes["checked_batches"]
                got = cells.served_readings(s, mix, seed, dev, stream,
                                            picked, {}, precision="fp8")
                emit({"seed": seed, "what": "control_fp8",
                      **cells.prefill_numbers(got),
                      "requests": len(got["gap"]), "readings": got})
    for seed in fault if train else []:
        t = time.perf_counter()
        run = harness.run_cell(spec, seed, 0.0, False, dev, t,
                               make_step=_half_batch_step)
        emit({"seed": seed, "what": "fault_half_batch", **run.numbers,
              "losses": run.notes["losses"]})
    return 0


if __name__ == "__main__":
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    sys.path[:] = [root, os.path.join(root, "src")] + \
        [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.exit(main())
