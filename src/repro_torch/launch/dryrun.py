"""Multi-pod dry run: trace every (arch x shape x mesh) cell on rank 0 of
a fake group, with no card.

The port's counterpart of the JAX package's ``launch/dryrun.py``.  The
dry run runs in a process of its own: its default process group is a
fake group (``torch.distributed``'s ``fake`` backend, which sends
nothing) of 256 ranks for ``--mesh single`` or 512 for ``--mesh
multi``, and this process is rank 0 -- the counterpart of the
reference's ``XLA_FLAGS`` placeholder devices.  Over it the port's
``make_production_mesh`` (16x16, or 2x16x16) is built, and the state,
batch and cache are *empty fake tensors* (``FakeTensorMode``: shapes
and dtypes, no storage) of rank 0's local shapes: ``lm.param_blocks``
/ ``local_shapes``, the ZeRO-1 blocks of ``steps.opt_specs`` and the
cache of ``steps._cache_shardings`` -- the reference's
``ShapeDtypeStruct``s.  Nothing is initialised.  Rank 0 holds the
largest of ``torch.chunk``'s uneven blocks, so its bytes are the worst
case of the mesh.  One call of the port's ``make_train_step``,
``make_prefill_step`` or ``make_decode_step`` then runs under
``launch.op_analysis.OpAnalysis``: its FLOPs, HBM traffic, collectives
and live bytes, per device.  A decode step writes at the last position
rank 0's sequence slice holds, so rank 0 writes the cache as every rank
of the reference's traced ``dynamic_update_slice`` does.

The tensors are fake ``cuda`` tensors where torch has a card, else fake
``cpu`` tensors (``trace_device`` in the record): a CPU-only torch's
autograd cannot record a graph on a fake ``cuda`` tensor (it needs the
device's stream guard).  The kernels' wrappers route a FakeTensor to
their fake custom ops whatever its device (``kernels.ops``), so the op
stream is the card's path either way: bf16 flash in the prefill, the
pack and unpack kernels in the gradient sync.

For each cell this writes a JSON record with the reference's keys
(``dryrun.py``'s ``analyze_cell``), but: ``lower_s`` / ``compile_s``
are one ``trace_s``; the XLA-only fields (``xla_cost_flops_no_loop_mult``,
``xla_cost_bytes_no_loop_mult``, ``cpu_bf16_upcast_artifact_gib`` and
``tpu_estimate_gib``) are left out, the tracer seeing the card's bf16
path, with no upcast to subtract; ``fits_16gib`` is ``fits_80gb``, a
fit against the H100's 80 GB.  The roofline terms are the H100's:

  * ``PEAK_FLOPS`` = 989e12 FLOP/s, bf16 dense (SXM);
  * ``HBM_BW`` = 3.35e12 B/s;
  * ``LINK_BW`` = 50e9 B/s a GPU, **an assumption**: one 400 Gb/s NDR
    port a GPU, as a 16-wide ``model`` axis spans two 8-GPU NVLink
    nodes; the collective term divides every collective's bytes by it
    (0 on a mesh of one rank, whose counted collectives send nothing).

``MODEL_FLOPS`` is 6·N·D to train and 2·N·D to serve, N the config's
``active_param_count()``, D the tokens of the step.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh single
  python -m repro_torch.launch.dryrun --all --mesh multi   # 512 ranks
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, get_config
from ..configs.shapes import SHAPES, ShapeConfig, cells
from ..models import lm
from ..optim.adamw import init_zero1_state
from . import mesh as _mesh
from . import steps
from .op_analysis import OpAnalysis, argument_bytes
from .steps import (StepConfig, make_cache, make_decode_step,
                    make_prefill_step, make_train_step)

PEAK_FLOPS = 989e12      # bf16 dense FLOP/s, H100 SXM
HBM_BW = 3.35e12         # B/s, H100 SXM HBM3
LINK_BW = 50e9           # B/s a GPU across nodes: an assumption (above)
HBM_BYTES = 80e9         # the H100's 80 GB

# where the records go, and where benchmarks.roofline_report reads them
ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


def production_shape(multi_pod: bool) -> Tuple[int, ...]:
    return (2, 16, 16) if multi_pod else (16, 16)


def mesh_name(shape: Sequence[int]) -> str:
    return "x".join(map(str, shape))


def trace_device() -> str:
    """``cuda`` where torch has a card, else ``cpu`` (the docstring)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def fake_world(n: int) -> None:
    """Make the default group a fake group of ``n`` ranks, this process
    rank 0; an existing fake group of at least ``n`` ranks is kept, any
    other group raises."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() < n:
            raise RuntimeError(
                f"dryrun: the default group is {dist.get_backend()} of"
                f" {dist.get_world_size()} ranks, not a fake group of {n};"
                f" run the dry run in a process of its own")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def model_flops(arch_id: str, shape: ShapeConfig) -> float:
    """6·N·D (train) or 2·N·D (serve): N active parameters, D tokens."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    return float((6 if shape.kind == "train" else 2)
                 * get_config(arch_id).active_param_count() * tokens)


def _batch(cfg: lm.ModelConfig, rows: int, seq_len: int, dev,
           labels: bool) -> Dict[str, torch.Tensor]:
    """Empty batch tensors of the reference's ``_batch_struct``."""
    d = cfg.d_model
    b = {}
    if cfg.frontend == "audio_stub":
        b["embeds"] = torch.empty(rows, seq_len, d, dtype=torch.bfloat16,
                                  device=dev)
    else:
        b["tokens"] = torch.empty(rows, seq_len, dtype=torch.int32,
                                  device=dev)
    if cfg.frontend == "vision_stub":
        b["patch_embeds"] = torch.empty(rows, 256, d, dtype=torch.bfloat16,
                                        device=dev)
        b["positions"] = torch.empty(3, rows, seq_len, dtype=torch.int32,
                                     device=dev)
    if labels:
        b["labels"] = torch.empty(rows, seq_len, dtype=torch.int32,
                                  device=dev)
    return b


def cell_call(arch_id: str, shape: ShapeConfig, mesh, scfg: StepConfig,
              dev, cfg: Optional[lm.ModelConfig] = None):
    """``(step, args, kwargs, parts)``: the step of one cell on ``mesh``
    and this rank's arguments, empty tensors on ``dev`` made by the
    caller's mode (fake in the dry run, real on the card), ``parts`` the
    arguments grouped by kind (params, opt, batch, cache)."""
    cfg = cfg or get_config(arch_id)
    kind, S, B = shape.kind, shape.seq_len, shape.global_batch
    # the parameters' and the cache's shapes of the step's config
    run_cfg = cfg.replace(param_dtype=scfg.param_dtype).with_tp(
        _mesh.model_size(mesh))
    model = lm.local_model(run_cfg, lm.param_blocks(run_cfg, mesh),
                           device=dev)
    if kind == "train":
        model.requires_grad_(True)
        opt = init_zero1_state(
            dict(model.named_parameters()), scfg.adam, mesh,
            steps.opt_specs(run_cfg, mesh)["m"],
            shapes=lm.param_shapes(run_cfg), units=lm.param_units(run_cfg))
        batch = _batch(run_cfg, B // _mesh.dp_size(mesh), S, dev, True)
        step = make_train_step(cfg, scfg, seq_len=S, batch=B, device=dev,
                               mesh=mesh)
        state = {"params": model, "opt": opt}
        return step, (state, batch), {}, {"params": model, "opt": opt,
                                          "batch": batch}
    cache = make_cache(run_cfg, scfg, batch=B, max_len=S, device=dev,
                       mesh=mesh)
    if kind == "prefill":
        batch = _batch(run_cfg, B, S, dev, False)
        step = make_prefill_step(cfg, scfg, seq_len=S, batch=B, device=dev,
                                 mesh=mesh)
        return step, (model, batch, cache), {}, {
            "params": model, "batch": batch, "cache": cache}
    # the last position rank 0's slice of the sequence holds
    pos = S // _mesh.size(mesh, steps._cache_axes(mesh, B)[1]) - 1
    step = make_decode_step(cfg, scfg, seq_len=S, batch=B, device=dev,
                            mesh=mesh)
    tokens = torch.empty(B, dtype=torch.int32, device=dev)
    kw = {}
    if cfg.frontend == "audio_stub":
        kw["embeds"] = torch.empty(B, 1, cfg.d_model, dtype=torch.bfloat16,
                                   device=dev)
    return step, (model, cache, tokens, pos), kw, {
        "params": model, "cache": cache, "batch": {"tokens": tokens, **kw}}


def _shape(shape) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def analyze_cell(arch_id: str, shape, *, multi_pod: bool = False,
                 scfg: StepConfig = StepConfig(), mesh_shape=None,
                 cfg: Optional[lm.ModelConfig] = None) -> dict:
    """One cell's record (the module docstring): one call of its step
    traced on rank 0 of a fake group.  ``shape`` is a name of ``SHAPES``
    or a ``ShapeConfig``; ``mesh_shape`` (default: the production mesh)
    is ``(data, model)`` or ``(pod, data, model)``; ``cfg`` replaces
    the arch's config (a smoke config in the tests)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    shape = _shape(shape)
    mesh_shape = tuple(mesh_shape or production_shape(multi_pod))
    n_chips = math.prod(mesh_shape)
    fake_world(n_chips)
    dev = torch.device(trace_device())
    mesh = _mesh.make_mesh(mesh_shape, ("pod", "data", "model")[
        -len(mesh_shape):], dev.type)
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args, kw, parts = cell_call(arch_id, shape, mesh, scfg, dev,
                                          cfg)
        part_bytes = {f"{k}_bytes": argument_bytes(v)
                      for k, v in parts.items()}
        t0 = time.perf_counter()
        with OpAnalysis((args, kw)) as a:
            out = step(*args, **kw)
        t_trace = time.perf_counter() - t0
        del out
    s = a.stats
    flops_dev = float(s.dot_flops)
    terms = {"compute_s": flops_dev / PEAK_FLOPS,
             "memory_s": float(s.hbm_bytes_min) / HBM_BW,
             "collective_s": (s.total_bytes / LINK_BW if n_chips > 1
                              else 0.0)}
    dominant = max(terms, key=terms.get)
    mf = model_flops(arch_id, shape)
    total = s.argument_bytes + s.peak_bytes
    return {
        "arch": arch_id, "shape": shape.name,
        "mesh": mesh_name(mesh_shape), "n_chips": n_chips,
        "sync_mode": scfg.sync_mode, "aggr_bytes": scfg.aggr_bytes,
        "seq_parallel": scfg.seq_parallel, "comm_dtype": scfg.comm_dtype,
        "trace_s": round(t_trace, 2), "trace_device": dev.type,
        "n_ops": s.n_ops,
        "memory": {
            "argument_bytes": s.argument_bytes,
            **part_bytes,
            "output_bytes": s.output_bytes,
            "temp_bytes": s.peak_bytes - s.output_bytes,
            "alias_bytes": 0,
            "total_per_device_bytes": int(total),
            "total_per_device_gib": round(total / (1 << 30), 3),
            "fits_80gb": bool(total <= HBM_BYTES),
        },
        "cost": {"flops_per_device": flops_dev,
                 "bytes_per_device": float(s.hbm_bytes_min),
                 "bytes_per_device_upper_bound": float(s.hbm_bytes)},
        "collectives": {k: v for k, v in s.to_dict().items()
                        if k not in ("dot_flops", "hbm_bytes",
                                     "hbm_bytes_min")},
        "roofline": {
            **terms,
            "dominant": dominant,
            "model_flops_global": mf,
            "model_flops_per_device": mf / n_chips,
            "useful_compute_ratio": (mf / n_chips / flops_dev
                                     if flops_dev else None),
        },
    }


def _scfg(args) -> StepConfig:
    return StepConfig(sync_mode=args.sync, aggr_bytes=args.aggr_bytes,
                      comm_dtype=args.comm_dtype or None,
                      seq_parallel=not args.no_seq_parallel,
                      ce_gather_targets=args.ce_gather,
                      flash_decode=args.flash_decode,
                      moe_chunk=args.moe_chunk,
                      capacity_factor=args.capacity_factor)


def run(args) -> int:
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    scfg = _scfg(args)
    if args.all:
        todo = [(a, s.name) for a in ARCH_IDS for s in cells(a)]
    else:
        todo = [(args.arch, args.shape)]
    multi = args.mesh == "multi"
    failures = 0
    t_all = time.perf_counter()
    for arch_id, shape_name in todo:
        tag = f"{arch_id}__{shape_name}__{args.mesh}"
        variant = args.suffix or (args.sync if args.sync != "partitioned"
                                  else "")
        if variant:
            tag += f"__{variant}"
        path = out_dir / f"{tag}.json"
        if path.exists() and not args.force:
            print(f"[skip] {tag} (exists)")
            continue
        print(f"[dryrun] {tag} ...", flush=True)
        try:
            rec = analyze_cell(arch_id, shape_name, multi_pod=multi,
                               scfg=scfg)
            path.write_text(json.dumps(rec, indent=1))
            r = rec["roofline"]
            print(f"  ok: trace={rec['trace_s']}s "
                  f"mem={rec['memory']['total_per_device_gib']}GiB "
                  f"compute={r['compute_s']:.4f}s "
                  f"memory={r['memory_s']:.4f}s "
                  f"collective={r['collective_s']:.4f}s "
                  f"dominant={r['dominant']}", flush=True)
        except Exception as e:
            failures += 1
            print(f"  FAILED: {type(e).__name__}: {e}", flush=True)
            (out_dir / f"{tag}.error.txt").write_text(traceback.format_exc())
    print(f"[dryrun] {len(todo)} cells in"
          f" {time.perf_counter() - t_all:.1f}s, {failures} failed",
          flush=True)
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--sync", default="partitioned",
                    choices=("bulk", "per_leaf", "partitioned"))
    ap.add_argument("--aggr-bytes", type=int, default=4 << 20)
    ap.add_argument("--comm-dtype", default="")
    ap.add_argument("--no-seq-parallel", action="store_true")
    ap.add_argument("--ce-gather", action="store_true",
                    help="naive take_along_axis CE targets (baseline)")
    ap.add_argument("--flash-decode", action="store_true",
                    help="partitioned-KV decode attention (optimized)")
    ap.add_argument("--moe-chunk", type=int, default=0)
    ap.add_argument("--capacity-factor", type=float, default=0.0)
    ap.add_argument("--suffix", default="",
                    help="artifact tag suffix for perf iterations")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(ART))
    args = ap.parse_args(argv)
    if not args.all and (not args.arch or not args.shape):
        ap.error("--arch/--shape or --all required")
    raise SystemExit(1 if run(args) else 0)


if __name__ == "__main__":
    main()
