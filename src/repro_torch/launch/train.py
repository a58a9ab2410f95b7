"""End-to-end training entry point of the port.

    python -m repro_torch.launch.train --arch llama3.2-1b --smoke \\
        --device cpu --steps 3
    python -m repro_torch.launch.train --arch llama3.2-1b \\
        --global-batch 4 --seq-len 1024 --steps 20
    torchrun --nproc-per-node 4 -m repro_torch.launch.train ...

The port's counterpart of the JAX package's ``launch/train.py``, with the
same flags plus ``--device`` (default ``cuda``).  It wires the synthetic
data stream, the early-bird gradient sync, AdamW, async checkpointing,
the preemption-safe loop and the straggler monitor together.  As the
JAX package's, it plans the mesh for the world
(``runtime.elastic.plan_mesh``, ``build_mesh``) and prints it; each
rank holds one device and ``global_batch / data`` rows of every batch,
and the AdamW moments are ZeRO-1 over the data axis (each rank keeps
its block; a checkpoint holds them whole, gathered when it is saved,
written by rank 0, and placed again on restore with the mesh's
shardings).  Under ``torchrun`` the process group comes from the
environment; otherwise a one-rank group is started through a
``FileStore`` in a temporary directory (``nccl`` on the card, ``gloo``
on the CPU), so the gradient all-reduce is always issued.  ``--tp M``
trains tensor parallel over a ``model`` axis of M ranks, as the JAX
package's: the state is built at ``cfg.with_tp(M)`` and each rank holds
its block of every leaf and its (model, data) block of the moments; a
checkpoint holds the whole leaves, assembled from the blocks when it is
saved, and ``--resume`` places them again by the mesh's shardings (a
checkpoint of another M restores where the padded shapes agree).  A
world smaller than M raises ``plan_mesh``'s ``ValueError``.  A Mamba
arch trains wherever M divides its d_inner (a rank's block of channels
may cut a head) and is refused (exit 2) elsewhere, where the JAX
package's ``device_put`` refuses its parameters.  Every architecture
trains but qwen2-vl-7b, which is refused (exit 2) as the JAX package's
training CLI fails on it: the synthetic stream makes no M-RoPE
``positions``, which its train step needs (``make_train_step`` trains
it when the batch holds them).  musicgen-medium trains on the stream's
frame embeddings; its unread ``embed`` gets a zero gradient, as in JAX.
``--resume`` continues from the latest checkpoint (exact, because the
data stream is stateless in the step index).  Prints the lines of the
JAX package's ``launch/train.py`` and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from ..ckpt.checkpoint import AsyncCheckpointer, latest_step, restore
from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..core.fabric_torch import resolve_device
from ..data import pipeline
from ..models import convert
from ..runtime import elastic
from ..runtime.fault_tolerance import (Heartbeat, StragglerMonitor,
                                       run_training_loop)
from .mesh import axis_index, dp_axes
from .steps import (StepConfig, batch_to_device, build_state,
                    make_train_step, opt_shardings, param_shardings)


def init_group(device: torch.device, tmpdir: str) -> bool:
    """Join the process group: from ``torchrun``'s environment if set,
    else a one-rank group through a ``FileStore`` under ``tmpdir``.
    Returns whether this call started it (and must destroy it)."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        store = dist.FileStore(os.path.join(tmpdir, "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="width multiplier on the smoke config")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--heads", type=int, default=0)
    ap.add_argument("--kv", type=int, default=0)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--sync", default="partitioned",
                    choices=("bulk", "per_leaf", "partitioned"))
    ap.add_argument("--aggr-bytes", type=int, default=1 << 20)
    ap.add_argument("--ckpt-dir", default="artifacts/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--param-dtype", default="float32")
    ap.add_argument("--peak-lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.scale != 1.0:
        cfg = cfg.replace(d_model=int(cfg.d_model * args.scale),
                          d_ff=int(cfg.d_ff * args.scale))
    over = {k: v for k, v in [("n_layers", args.layers),
                              ("d_model", args.d_model),
                              ("d_ff", args.d_ff), ("vocab", args.vocab),
                              ("n_heads", args.heads), ("n_kv", args.kv)]
            if v}
    if over:
        cfg = cfg.replace(**over, head_dim=0)
    cfg = cfg.replace(param_dtype=args.param_dtype)
    if cfg.mrope_sections is not None:
        print(f"{cfg.name}: the synthetic data stream makes no M-RoPE"
              f" positions (3, B, S), which the train step needs; the JAX"
              f" package's training CLI (python -m repro.launch.train"
              f" --arch {args.arch}) fails on the same batch."
              f"  make_train_step"
              f" trains it on batches that hold them.", file=sys.stderr)
        return 2

    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        own = init_group(dev, tmp)
        try:
            return _train(args, cfg, dev)
        finally:
            if own:
                dist.destroy_process_group()


def _train(args, cfg, dev: torch.device) -> int:
    rank, world = dist.get_rank(), dist.get_world_size()
    if dev.type == "cuda" and world > 1:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    plan = elastic.plan_mesh(world, args.tp)
    if args.global_batch % plan.data:
        raise ValueError(f"--global-batch {args.global_batch} is not a"
                         f" multiple of the {plan.data} data-parallel ranks")
    mesh = elastic.build_mesh(plan, device=dev)
    print(f"mesh: data={plan.data} model={plan.model} "
          f"(devices={plan.n_devices}, backend {dist.get_backend()},"
          f" device {dev})")
    scfg = StepConfig(sync_mode=args.sync, aggr_bytes=args.aggr_bytes,
                      param_dtype=args.param_dtype, peak_lr=args.peak_lr,
                      warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps)
    try:
        step_fn = make_train_step(cfg, scfg, seq_len=args.seq_len,
                                  batch=args.global_batch, device=dev,
                                  mesh=mesh)
    except NotImplementedError as e:  # a Mamba arch M does not place
        print(f"--tp {args.tp}: {e}", file=sys.stderr)
        return 2
    state = build_state(cfg, 0, dev, scfg.adam, mesh=mesh)
    start = 0
    ckpt_dir = Path(args.ckpt_dir) / cfg.name.replace("/", "_")
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    if args.resume and latest_step(ckpt_dir) is not None:
        start, tree = restore(ckpt_dir, convert.state_to_jax(state),
                              shardings={"params": param_shardings(cfg, mesh),
                                         "opt": opt_shardings(cfg, mesh)})
        state = convert.state_from_jax(tree, cfg, device=dev, mesh=mesh)
        print(f"resumed from step {start}")

    stream = pipeline.for_model(cfg, args.seq_len, args.global_batch,
                                host_index=axis_index(mesh, dp_axes(mesh)),
                                host_count=plan.data)
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"tokens/step={args.global_batch * args.seq_len}")
    losses = []

    def on_loss(step, loss):
        losses.append(loss)
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f}", flush=True)

    def get_batch(step):
        return batch_to_device(stream.batch(step), dev)

    checkpointer = AsyncCheckpointer(ckpt_dir, to_tree=convert.state_to_jax,
                                     write=rank == 0)
    t0 = time.time()
    with Heartbeat(ckpt_dir / f"heartbeat{rank}.json") as hb:
        report = run_training_loop(
            step_fn=step_fn, state=state, start_step=start,
            num_steps=args.steps, checkpoint_every=args.ckpt_every,
            checkpointer=checkpointer, get_batch=get_batch,
            on_loss=on_loss, straggler=StragglerMonitor(), heartbeat=hb)
    dt = time.time() - t0
    tok_s = report.steps_run * args.global_batch * args.seq_len / dt
    print(f"done: {report.steps_run} steps in {dt:.1f}s "
          f"({tok_s:.0f} tok/s, {dt / max(report.steps_run, 1):.2f}s/step); "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"final ckpt step {report.final_step}")
    if report.straggler_steps:
        print(f"stragglers at {report.straggler_steps}")
    print(json.dumps({
        "arch": cfg.name, "device": str(dev),
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "world": world, "sync": args.sync, "aggr_bytes": args.aggr_bytes,
        "param_dtype": args.param_dtype, "global_batch": args.global_batch,
        "seq_len": args.seq_len, "steps": report.steps_run,
        "seconds": dt, "tokens_per_s": tok_s, "losses": report.losses,
        "final_step": report.final_step,
        "sync_all_reduces_last_step": step_fn.log.count()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
