"""Early-bird gradient-sync rows: the three sync modes on 8 gloo ranks.

The counterpart of the JAX package's ``benchmarks/jax_earlybird.py``,
which lowers one step under ``shard_map`` on 8 host devices and counts
the all-reduces of its HLO.  Here 8 ``gloo`` ranks run on the CPU, each
in its own process (the card machine holds one device, and multi-rank
work is shown on gloo ranks).  Every rank takes 2 of the 16 sequences of
128 tokens and runs the reference's model (the llama3.2-1b smoke config
at 8 layers, d_model 128, d_ff 512, vocabulary 2048, f32) through one
step of loss, backward and gradient sync in each mode (buckets of at
most 64 KiB in partitioned mode), after one warm-up step.  Per mode it
reports, as counted by ``compat.CALLS`` over that step, the all-reduces
a step and the bytes a rank contributes to them, and the step's wall
time.  The reference's ``pred_ici_us`` (a TPU interconnect prediction)
has no counterpart: the port states no TPU number.

    python -m repro_torch.benchmarks.earlybird
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from .common import emit

WORLD = 8
GLOBAL_BATCH, SEQ = 16, 128
AGGR_BYTES = 1 << 16
MODES = ("bulk", "per_leaf", "partitioned")
TIMEOUT_S = 600


def model_config():
    """The reference benchmark's model: the smoke config, widened."""
    from ..configs import get_smoke_config
    return get_smoke_config("llama3.2-1b").replace(
        n_layers=8, d_model=128, d_ff=512, vocab=2048)


def global_batch(cfg):
    """Seeded tokens and labels of the whole step, (16, 128) each."""
    import numpy as np
    return {"tokens": np.random.default_rng(1).integers(
                0, cfg.vocab, (GLOBAL_BATCH, SEQ)),
            "labels": np.random.default_rng(2).integers(
                0, cfg.vocab, (GLOBAL_BATCH, SEQ))}


def rank_main(rank: int, store_path: str, out_path: str) -> None:
    """One rank: a warm-up and a measured step in each mode; writes
    ``{mode: {"all_reduces", "bytes", "wall_s", "loss"}}`` as JSON."""
    import torch
    import torch.distributed as dist

    from .. import compat
    from ..core.earlybird import SyncConfig, value_and_synced_grad
    from ..launch.steps import batch_to_device, build_state
    from ..models import lm
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        cfg = model_config()
        per = GLOBAL_BATCH // WORLD
        batch = batch_to_device(
            {k: v[rank * per:(rank + 1) * per]
             for k, v in global_batch(cfg).items()}, "cpu")
        model = build_state(cfg, 0, "cpu")["params"]
        out = {}
        for mode in MODES:
            vg = value_and_synced_grad(
                lambda m, b, param_hook: lm.loss_fn(cfg, m, b,
                                                    param_hook=param_hook),
                SyncConfig(mode=mode, aggr_bytes=AGGR_BYTES))
            vg(model, batch)  # warm-up
            dist.barrier()
            before = dict(compat.CALLS)
            t0 = time.perf_counter()
            loss, _ = vg(model, batch)
            wall = time.perf_counter() - t0
            out[mode] = {
                "all_reduces": compat.CALLS["all_reduce"]
                - before["all_reduce"],
                "bytes": compat.CALLS["all_reduce_bytes"]
                - before["all_reduce_bytes"],
                "logged": vg.log.count(), "wall_s": wall,
                "loss": float(loss)}
        with open(out_path, "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(timeout: float = TIMEOUT_S) -> list:
    """Spawn the 8 ranks and return each one's result, rank by rank.
    Raises ``RuntimeError`` with the failing rank's output tail."""
    src = Path(__file__).resolve().parents[2]
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{src}{os.pathsep}" + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.benchmarks.earlybird",
             "--rank", str(r), "--store", os.path.join(tmp, "store"),
             "--out", os.path.join(tmp, f"rank{r}.json")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(WORLD)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"earlybird rank {r} exited"
                                   f" {p.returncode}: {log[-2000:]}")
        return [json.loads(Path(tmp, f"rank{r}.json").read_text())
                for r in range(WORLD)]


def rows():
    """One row a mode: the slowest rank's step wall time in us, with the
    all-reduces a step and rank 0's bytes a rank."""
    try:
        ranks = run_ranks()
    except (RuntimeError, subprocess.TimeoutExpired) as e:
        return [("earlybird/FAILED", 0.0, str(e)[-200:].replace("\n", " "))]
    out = []
    for mode in MODES:
        d = ranks[0][mode]
        wall = max(r[mode]["wall_s"] for r in ranks)
        out.append((f"earlybird/{mode}/wall", wall * 1e6,
                    f"ranks={WORLD},all_reduces={d['all_reduces']},"
                    f"ar_bytes={d['bytes']}"))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m"
                                 " repro_torch.benchmarks.earlybird",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--store", default="", help=argparse.SUPPRESS)
    ap.add_argument("--out", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is None:
        emit(rows())
    else:
        rank_main(args.rank, args.store, args.out)


if __name__ == "__main__":
    main()
