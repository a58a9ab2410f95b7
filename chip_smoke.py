#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` and
drives the port's paths on the card -- the stencil simulator, model
serving, training and the paper's scenarios -- phase by phase; every
phase prints one line and any failure exits non-zero without a result:

  1. the card (``nvidia-smi`` name and power limit) and the build of
     every kernel source, one ``nvcc`` each, started together, with
     each flash kernel's registers and spills (``-Xptxas -v``) and the
     HGMMA and UTMALDG instructions in its SASS (``cuobjdump``);
  2. the fused fabric kernel against its plain PyTorch version
     (``fabric_scan_ref``) on the card, bitwise, in finish and arrivals
     mode at the 32768-rank ``weak_scaling_xxl`` shapes and on a random
     grid whose rank-records are ragged, one Zipf-heavy rank far the
     deepest;
  3. the main path: the ``weak_scaling_xxl`` smoke tier on engine
     ``cuda``, held against the golden ``BENCH_scenarios.json``, with
     the kernel's launch count over that run: one per super-batch;
  4. engine agreement: the ``weak_scaling_xl`` smoke tier on engines
     ``torch`` and ``cuda``, bitwise equal and both on the baseline;
  5. the warm path: a 512-rank stencil through ``CudaFabric`` with the
     normal adaptive routing, and a second warm batch, exact against the
     NumPy engine;
  6. times at the XXL shapes: the kernel's per super-batch (event
     window, host enqueue and profiler device time, against the bound
     in the bytes its layout moves; the earlier stage-bucketed layout's
     count is printed beside it),
     the plain version's, the torch engine's, the kernel's on the random
     grid of phase 2, and the XXL smoke tier's wall time with its host
     assembly;
  7. the flash-attention kernels against their plain version
     (``flash_attention_plain``) on the card, f32 (the SIMT kernel) and
     bf16 (the wgmma kernel), at the llama3.2-1b prefill shape, a gemma2
     shape where the window bites, ragged, decode-like, and head dims 16
     and 128;
  8. the serving path: llama3.2-1b at full width (random weights from
     seed 0), the prefill/decode check in f32, then 4 prompts of 1024
     tokens prefilled in bf16 into a 1056-position cache and 32 tokens
     decoded greedily, with the flash kernels' launch counts over that
     run (every launch through the wgmma kernel) and the prefill's
     logits against the same prefill through ``masked_attention``;
  9. times at the llama prefill shape and the gemma2 window shape: the
     bf16 flash kernel, its plain version and
     ``scaled_dot_product_attention`` (a yardstick only, never on the
     port's path), the bound, the share of it and the ratio to SDPA;
     the f32 SIMT kernel at the llama shape; the batch's prefill and
     decode per token and the prefill's profile;
 10. the bucket pack/unpack and quant8 kernels, built in phase 1 with
     the others (one ``nvcc`` per source, all four started together),
     bound;
 11. pack and unpack against their plain versions, bitwise: every
     f32/bf16 pair, sizes 1 to 129, scalar leaves, 300 leaves, a stacked
     leaf of 16 segments, the 64 MiB bulk bucket, segments that are
     views at odd element offsets (every pair, unpacked from a bucket
     view at an odd offset), a bf16 bucket whose segments sit at odd
     offsets, a bucket above the by-value descriptor capacity (the
     device-table route), round trips;
 12. quantize and dequantize against their plain versions, bitwise: n =
     1, 255, 256, 257 and 2^24 + 100, a zero block, magnitudes 1e-6 and
     1e4, exact ties, round trips, blocks holding NaN, +inf and -inf and
     a NaN in the ragged tail (JAX's scales NaN and inf, values 0), bf16
     inputs, views at odd element offsets (the scalar route) and values
     dequantized from an odd offset, one launch a call on its route;
 13. the training path: llama3.2-1b at full width and depth in f32
     (random weights from seed 0), 4 x 1024 tokens a step, through
     ``make_train_step`` on a one-rank ``nccl`` group: partitioned for 6
     steps, bulk and per_leaf for 2; the step-0 loss band, pack/unpack
     launches per step equal to the plan's multi-leaf buckets,
     all-reduces per step equal to the plan's buckets plus the loss's
     (a stacked leaf is one), every bucket's descriptors passed by
     value, equal
     step-0 losses and gradients across the modes, and the smoke config
     trained on the CPU and on the card within the CPU tests'
     tolerances;
 14. times: pack/unpack at the 64 MiB and 16 KiB buckets beside
     ``torch.cat`` / ``torch._foreach_copy_``, with their host enqueue
     times, and a profile of ten pack and unpack calls on each that must
     show no host-to-device copy; quantize (f32 and bf16) and dequantize
     at 2^24 elements, each with its bound, event window, host enqueue
     and profiler device time (10 calls must trace 10 kernels and no
     host-to-device copy), dequantize beside ``torch.mul`` of the int8
     values and their scales in window and device time; the train step and tokens/s per mode,
     peak memory and the profile of one step;
 15. the paper's scenarios: the full grids of Figs 4-8, ``halo1d``,
     ``steady_state``, ``imbalance``, ``serving``, ``faults``,
     ``membership``, ``serving_faults`` and ``recovery`` (155 records)
     on engine ``cuda`` against the baseline, each with its wall time
     and the fabric kernel's launches, which must be the reference's
     routing (halo1d 3, faults 3, every other spec 0); the smoke records
     of halo1d, imbalance, serving, membership and the fault-free ones
     of faults with the adaptive cutoffs at 0, bitwise against engine
     ``reference`` with at least one launch a record (warm VCI, NIC and
     wire state carried from launch to launch across serving's waves
     and membership's epochs); the Fig-5/Fig-6 crossover; 32 chaos
     campaigns of ``cuda`` against ``reference`` with no violation; then
     the kernel table as one JSON line.

The last line is ``{"ok": true, "device": {...}}``.  The script imports
nothing of the JAX package; it reads the baseline as data.

    python3 chip_smoke.py --fabric-times [TREE]

times only the fabric kernel of the source tree ``TREE`` (default: this
checkout; an earlier commit unpacked with ``git archive`` works too), on
the XXL super-batch and the random grid of phase 2, and prints one JSON
line: the way to hold two versions of the kernel against each other in
one session on one card.

    python3 chip_smoke.py --quant8-times [TREE]

does the same for the quantize and dequantize kernels of ``TREE`` at 2^24
f32 elements (and quantize of bf16): launches a call, the event window,
host enqueue and profiler device time a call, and the kernels' output on
a block holding a NaN and one holding ``+inf`` (the scales, and the int8
and dequantized values at the non-finite elements), as one JSON line.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BASELINE = ROOT / "BENCH_scenarios.json"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp64 vector rate,
# dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
BF16_TC_FLOPS = 989e12
F32_FLOPS = 67e12  # f32 on the CUDA cores (the SIMT flash kernel)

# Flash kernel vs its plain version: the reference's own tolerances
# (tests/test_kernels.py), as rtol = atol.
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# Prefill logits through the flash kernel vs through masked_attention,
# both bf16, max |dlogit|.  Both round the probabilities to bf16 before
# P.V, but different values (the kernel unnormalised, per key tile
# against the running max; the model path normalised) and they sum in
# other orders; the difference passes through 16 bf16 layers; the logits
# are themselves bf16 products, whose ulp is 0.03 near the top logit of
# about 4, so 0.25 allows eight ulps.
SERVE_LOGIT_TOL = 0.25


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _timed(fn, device, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()``: CUDA events around each call on
    the card (after ``warmup`` calls), the host clock on the CPU."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def _host_ms(fn, device, reps: int) -> float:
    """Median host milliseconds to enqueue ``fn()`` (no synchronisation
    inside the timed span; the device is drained between calls)."""
    import torch
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        if device.type == "cuda":
            torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


def _smoke_point(spec, approach: str) -> dict:
    from repro_torch.experiments.engine import _stencil_sim_kwargs
    (p,) = [p for p in spec.points("smoke") if p["approach"] == approach]
    return _stencil_sim_kwargs(p)


def _grid(points):
    """Grid items and finish specs of stencil points, as the main path
    assembles them."""
    from repro_torch.core import simulator as sim
    entries = sim._grid_entries(points)
    items = [e[2] for e in entries]
    fins = [sim._cuda_finish_spec(e[0], e[1]) for e in entries]
    return items, fins


def _outputs_equal(a, b):
    """Bitwise equality of two kernel outputs (a tensor or a tuple)."""
    import torch
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _max_abs_err(a, b) -> float:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def _random_ragged_grid(device):
    """A random super-batch whose rank-records are ragged: Zipf-skewed
    senders, so rank 0's record is far the deepest (about a quarter of
    the messages) and one thread's chain the longest."""
    import numpy as np
    from repro_torch.core import fabric_cuda as fc
    from repro_torch.core.fabric import DEFAULT_NET
    from repro_torch.core.state import grid_item_from_arrays
    rng = np.random.default_rng(2024)
    n_ranks, n_vcis, F = 2048, 4, 24000
    lens = rng.integers(1, 40, size=F)
    fsrc = np.minimum(rng.zipf(1.3, size=F) - 1, n_ranks - 1)
    fdst = rng.integers(0, n_ranks, size=F)
    fid = rng.permutation(np.repeat(np.arange(F), lens))
    n = fid.shape[0]
    item = grid_item_from_arrays(
        t_ready=np.sort(rng.uniform(0.0, 50e-6, size=n)),
        nbytes=rng.choice([64.0, 2048.0, 16384.0, 131072.0], size=n),
        vci=rng.integers(0, n_vcis, size=n),
        thread=rng.integers(0, 4, size=n), put=rng.random(n) < 0.2,
        am_copy=rng.random(n) < 0.05, src=fsrc[fid], dst=fdst[fid],
        cfg=DEFAULT_NET, n_vcis=n_vcis, n_ranks=n_ranks)
    fin = fc.FinishSpec(fid=fid, foff=rng.uniform(0.0, 1e-6, size=F),
                        fdst=fdst, n_ranks=n_ranks)
    return item, fin


def _scan_bytes(ops) -> int:
    """Bytes the super-batch moves at least in the kernel's layout:
    every input read once (three float64 columns, the slot and output
    words, the finish offsets, the record descriptors and block starts,
    warm clocks), every output written once."""
    n, (g1, r, g3) = ops.n, ops.sizes
    inputs = 32 * n + 4 * ops.desc.numel() + 4 * ops.cta.numel()
    if ops.init is not None:
        inputs += 8 * (g1 + r + g3)
    if ops.finish:
        return inputs + 8 * n + 8 * ops.n_out
    return inputs + 8 * n + 8 * (g1 + r + g3)


def _legacy_bytes(ops, fins) -> int:
    """The same work's bytes as the earlier stage-bucketed layout counted
    them (finish mode, exact-depth buckets): four float64 columns, five
    int32 bucket indices per message, the stage clocks, per flow its
    permutation, offset and rank index, and one float per receiving
    rank.  Printed beside the bound for continuity only: the bound
    counts the bytes this layout moves (:func:`_scan_bytes`)."""
    import numpy as np
    g1, r, g3 = ops.sizes
    flows = sum(len(f.foff) for f in fins)
    recv = sum(len(np.unique(f.fdst)) for f in fins)
    return 52 * ops.n + 8 * (g1 + r + g3) + 16 * flows + 8 * recv


def _scan_ops(ops) -> int:
    """Float64 operations of the super-batch: max and add in each of the
    three queues and the two adds of the delivery tail per message, the
    rendezvous add where one is paid, and in finish mode the offset add
    and the max into the rank."""
    n_rdv = int((ops.slot < 0).sum())
    return (10 if ops.finish else 8) * ops.n + n_rdv


# (name, B, H, Hkv, Sq, Sk, D, causal, window, softcap)
FLASH_CASES = (
    ("llama-prefill", 4, 32, 8, 1024, 1024, 64, True, 0, None),
    ("gemma-window", 1, 16, 8, 4608, 4608, 256, True, 4096, 50.0),
    ("ragged", 1, 4, 2, 1000, 1000, 64, True, 0, None),
    ("decode-like", 2, 4, 2, 1, 256, 64, False, 0, None),
    ("d16", 1, 4, 2, 256, 256, 16, True, 0, None),
    ("d128", 1, 4, 1, 256, 256, 128, True, 0, None),
)
# The same cases cut for a CPU rehearsal (``run("cpu", small=True)``).
FLASH_CASES_SMALL = (
    ("llama-prefill", 1, 4, 2, 128, 128, 64, True, 0, None),
    ("gemma-window", 1, 2, 1, 160, 160, 256, True, 96, 50.0),
    ("ragged", 1, 2, 1, 100, 100, 64, True, 0, None),
    ("decode-like", 2, 4, 2, 1, 256, 64, False, 0, None),
    ("d16", 1, 4, 2, 64, 64, 16, True, 0, None),
    ("d128", 1, 4, 1, 64, 64, 128, True, 0, None),
)


def _flash_inputs(case, dtype, device, seed=0):
    import torch
    _, b, h, hkv, sq, sk, d, *_ = case
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=device).to(dtype)
                 for shape in ((b, h, sq, d), (b, hkv, sk, d),
                               (b, hkv, sk, d)))


def _flash_kw(case) -> dict:
    *_, causal, window, cap = case
    return dict(causal=causal, window=window, softcap=cap)


def _attn_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps: the work this input needs."""
    import numpy as np
    rows = np.arange(sq)
    hi = np.minimum(rows + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(rows - window + 1, 0) if window > 0 else np.zeros(sq)
    return int(np.maximum(hi - lo, 0).sum())


def _flash_bound(case, itemsize: int):
    """Least time of one call: the larger of its FLOPs (QK^T and PV,
    2 * 2 * D per kept pair) at the peak of its type (bf16: the dense
    tensor cores; f32: the CUDA cores, the SIMT kernel's) and q, k, v
    and o read or written once at the HBM rate."""
    _, b, h, hkv, sq, sk, d, causal, window, _ = case
    flops = 4 * b * h * d * _attn_pairs(sq, sk, causal, window)
    nbytes = itemsize * d * (2 * b * h * sq + 2 * b * hkv * sk)
    rate = BF16_TC_FLOPS if itemsize == 2 else F32_FLOPS
    t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def flash_phase(dev, small: bool = False) -> dict:
    """Phase 7: the flash kernels against their plain version on every
    case, f32 through the SIMT kernel and bf16 through the wgmma kernel.
    Returns the largest |difference| per kernel."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    errs = {"simt": [], "wgmma": []}
    for case in FLASH_CASES_SMALL if small else FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _flash_inputs(case, dtype, dev)
            kw = _flash_kw(case)
            variant = fa.kernel_variant(q.dtype, k.dtype, v.dtype)
            check(variant == ("wgmma" if dtype == torch.bfloat16
                              else "simt"), f"flash {case[0]} {dtype}:"
                  f" dispatched to the {variant} kernel")
            before = fa.LAUNCHES[f"flash_attention_{variant}"]
            got = ops.flash_attention(q, k, v, **kw)
            check(fa.LAUNCHES[f"flash_attention_{variant}"] == before + 1
                  or dev.type != "cuda",
                  f"flash {case[0]}: the {variant} kernel did not launch")
            want = fa.flash_attention_plain(q, k, v, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"flash {case[0]}: shape or dtype differs")
            check(bool(torch.isfinite(got).all()),
                  f"flash {case[0]}: non-finite output")
            tol = FLASH_TOL[str(dtype).split(".")[1]]
            g32, w32 = got.float(), want.float()
            err = float((g32 - w32).abs().max())
            ok = bool(((g32 - w32).abs() <= tol + tol * w32.abs()).all())
            check(ok, f"flash {case[0]} {dtype}: max|diff| {err!r} beyond"
                      f" rtol = atol = {tol}")
            errs[variant].append(err)
            del q, k, v, got, want, g32, w32
    print(f"flash kernels vs plain: {len(errs['simt'])} cases each (f32"
          f" SIMT within {FLASH_TOL['float32']}, max_abs_err"
          f" {max(errs['simt'])!r}; bf16 wgmma within"
          f" {FLASH_TOL['bfloat16']}, max_abs_err {max(errs['wgmma'])!r})")
    return {k: max(e) for k, e in errs.items()}


def serving_phase(dev, small: bool = False) -> dict:
    """Phase 8: the serving path at full llama3.2-1b width (the smoke
    config when ``small``).  Returns what phase 9 and the kernel table
    need."""
    import torch
    from repro_torch import serve
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import StepConfig, make_cache
    from repro_torch.models import lm

    arch = "llama3.2-1b"
    cfg = (get_smoke_config if small else get_config)(arch)
    batch, prompt_len, gen = (4, 64, 8) if small else (4, 1024, 32)
    t0 = time.perf_counter()
    model = serve.build_model(cfg, 0, dev)  # f32
    n_matrix = sum(p.numel() for p in model.parameters() if p.dim() >= 2)
    check(n_matrix == cfg.param_count(),
          f"parameters {n_matrix} != param_count {cfg.param_count()}")
    err_cd = serve.check_consistency(
        cfg, model, serve.make_prompts(cfg, 2, 64, 1, dev))
    check(err_cd < serve.CONSISTENCY_TOL,
          f"prefill/decode mismatch {err_cd!r} (f32)")
    scfg = StepConfig()
    model = model.to(torch.bfloat16)
    scfg_cfg = cfg.replace(param_dtype=scfg.param_dtype)
    prompts = serve.make_prompts(cfg, batch, prompt_len, 2, dev)
    t_setup = time.perf_counter() - t0

    for key in fa.LAUNCHES:
        fa.LAUNCHES[key] = 0
    out = serve.generate(cfg, scfg, model, prompts, gen)
    launches = dict(fa.LAUNCHES)
    check(launches["flash_attention"] == cfg.n_layers or dev.type != "cuda",
          f"serving path launched the flash kernel"
          f" {launches['flash_attention']} times, not once per layer"
          f" ({cfg.n_layers})")
    check(launches["flash_attention_wgmma"] == launches["flash_attention"]
          and launches["flash_attention_simt"] == 0,
          f"serving path's flash launches did not all go through the wgmma"
          f" kernel: {launches}")
    logits = out["prefill_logits"]
    toks = out["tokens"]
    check(tuple(logits.shape) == (batch, cfg.vocab_padded)
          and bool(torch.isfinite(logits).all()), "prefill logits")
    check(tuple(toks.shape) == (batch, gen) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab, "generated tokens")

    ref_logits, _ = lm.prefill(
        scfg_cfg, model, {"tokens": prompts},
        cache=make_cache(cfg, scfg, batch=batch, max_len=prompt_len + gen,
                         device=dev), flash=False)
    diff = float((logits - ref_logits).abs().max())
    a_k, a_r = logits.argmax(-1), ref_logits.argmax(-1)
    same = int((a_k == a_r).sum())
    # a near-tie may flip the argmax: then the two tops must agree within
    # the logit tolerance under the reference's own logits
    gap = float((ref_logits.gather(1, a_r[:, None])
                 - ref_logits.gather(1, a_k[:, None])).max())
    print(f"serving llama3.2-1b{' smoke' if small else ''}: {n_matrix}"
          f" matrix parameters == param_count; prefill/decode f32 max|d|"
          f" {err_cd!r} (< {serve.CONSISTENCY_TOL}); bf16 prefill"
          f" {batch}x{prompt_len} + {gen} decode steps, flash launches"
          f" {launches['flash_attention']} (wgmma"
          f" {launches['flash_attention_wgmma']}, simt"
          f" {launches['flash_attention_simt']}); flash vs"
          f" masked_attention prefill max|dlogit|"
          f" {diff!r} (tol {SERVE_LOGIT_TOL}), argmax equal {same}/{batch}"
          f" (top gap {gap!r}); setup {t_setup:.3f} s")
    check(diff <= SERVE_LOGIT_TOL,
          f"prefill logits through flash and masked_attention differ by"
          f" {diff!r}")
    check(same == batch or gap <= SERVE_LOGIT_TOL,
          "prefill argmax differs from masked_attention beyond a near-tie")
    return {"cfg": cfg, "scfg": scfg, "model": model, "prompts": prompts,
            "gen": gen, "launches": launches}


def _device_split(fn, dev):
    """(wall ms, device-busy ms, device events, every (device ms, name,
    count) by device time, largest first) of one call of ``fn``, from
    ``torch.profiler``; busy is the sum of the device time of every
    traced device event (kernels, copies, fills: one stream, so none
    overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
    evs = [(e.self_device_time_total / 1e3, e.key, e.count)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(t for t, _, _ in evs)
    return wall, busy, sum(c for _, _, c in evs), sorted(evs, reverse=True)


def _profile_serving(dev, serving: dict) -> None:
    """Device-busy share of one prefill and of eight decode steps."""
    from repro_torch.launch.steps import (make_cache, make_decode_step,
                                          make_prefill_step)
    cfg, scfg, model = serving["cfg"], serving["scfg"], serving["model"]
    prompts = serving["prompts"]
    b, s = prompts.shape
    cache = make_cache(cfg, scfg, batch=b, max_len=s + 8, device=dev)
    prefill = make_prefill_step(cfg, scfg, seq_len=s, batch=b, device=dev)
    decode = make_decode_step(cfg, scfg, seq_len=s + 8, batch=b, device=dev)
    tok = prompts[:, -1]

    def steps8():
        for t in range(s, s + 8):
            decode(model, cache, tok, t)
    for name, fn, n in (("prefill", lambda: prefill(model, prompts, cache),
                         1), ("decode", steps8, 8)):
        wall, busy, events, top = _device_split(fn, dev)
        if busy <= 0.0:
            print(f"profile {name}: no device time traced")
            continue
        tops = ", ".join(f"{k[:40]} {t / n:.3f} ms" for t, k, _ in top[:3])
        flash = [(t, c) for t, k, c in top if "flash" in k]
        print(f"profile {name} (per call): wall {wall / n:.3f} ms, device"
              f" busy {busy / n:.3f} ms, idle share {1 - busy / wall:.3f},"
              f" {events / n:.1f} device events; flash kernels"
              f" {sum(t for t, _ in flash) / n:.3f} ms in"
              f" {sum(c for _, c in flash) / n:.1f} launches; top: {tops}")


def _sdpa(q, k, v, case):
    """One ``scaled_dot_product_attention`` call on the operands of a
    flash case: GQA by ``enable_gqa`` (K/V expanded outside where the
    PyTorch has no such argument); a window as a boolean mask.  It has
    no softcap: for a softcap case it is a yardstick of the same shape,
    not the same function."""
    import torch
    import torch.nn.functional as F
    _, _, h, hkv, sq, sk, _, causal, window, _ = case
    kw = {}
    if window > 0:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        kw["attn_mask"] = (cols <= rows) & (rows - cols < window)
    else:
        kw["is_causal"] = causal
    try:
        F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      enable_gqa=True, **kw)
    except TypeError:  # a PyTorch without enable_gqa: expand outside
        ke = k.repeat_interleave(h // hkv, dim=1)
        ve = v.repeat_interleave(h // hkv, dim=1)
        return lambda: F.scaled_dot_product_attention(q, ke, ve, **kw)


def _flash_times(case, dtype, dev, reps: int) -> dict:
    """Kernel, plain version and SDPA times of one flash case, with its
    bound, the share of the bound and the kernel/SDPA ratio."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    q, k, v = _flash_inputs(case, dtype, dev, seed=1)
    kw = _flash_kw(case)
    ms = _timed(lambda: ops.flash_attention(q, k, v, **kw), dev, reps)
    plain_ms = _timed(lambda: fa.flash_attention_plain(q, k, v, **kw), dev,
                      max(3, reps // 4))
    lib_ms = _timed(_sdpa(q, k, v, case), dev, reps)
    bound_ms, bound_by, flops, nbytes = _flash_bound(
        case, torch.finfo(dtype).bits // 8)
    out = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"times flash {case[0]} {tuple(case[1:7])}"
          f" {str(dtype).split('.')[1]}"
          f" ({fa.kernel_variant(q.dtype, k.dtype, v.dtype)} kernel):"
          f" {ms:.4f} ms, flash_attention_plain {plain_ms:.4f} ms,"
          f" scaled_dot_product_attention {lib_ms:.4f} ms"
          f"{' (no softcap)' if case[-1] else ''}; bound {bound_ms:.4f} ms"
          f" ({bound_by}: {flops} FLOPs, {nbytes} bytes), share of bound"
          f" {bound_ms / ms:.4f}, kernel/SDPA {ms / lib_ms:.3f}")
    return out


def serving_times(dev, serving: dict, errs: dict,
                  small: bool = False) -> list:
    """Phase 9: times at the llama prefill and gemma2 window shapes and
    of the serving path.  Returns the flash kernels' table entries."""
    import torch
    from repro_torch import serve

    cases = FLASH_CASES_SMALL if small else FLASH_CASES
    reps = 10 if dev.type == "cuda" else 3
    wgmma = _flash_times(cases[0], torch.bfloat16, dev, reps)
    _flash_times(cases[1], torch.bfloat16, dev, max(3, reps // 2))
    simt = _flash_times(cases[0], torch.float32, dev, max(3, reps // 2))
    runs = [serve.generate(serving["cfg"], serving["scfg"], serving["model"],
                           serving["prompts"], serving["gen"])
            for _ in range(3)]
    prefill_ms = sorted(r["prefill_ms"] for r in runs)[1]
    decode_ms = sorted(r["decode_ms_per_token"] for r in runs)[1]
    b, s = serving["prompts"].shape
    if dev.type == "cuda":
        _profile_serving(dev, serving)
    print(f"times serving {b}x{s} prefill {prefill_ms:.3f} ms, decode"
          f" {decode_ms:.3f} ms per token (median of 3, host clock)")
    entry = {"route": "cuda",
             "source": "src/repro_torch/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:124"}
    launches = serving["launches"]
    return [
        {"name": "flash_attention", **entry,
         "launches": launches["flash_attention_wgmma"],
         "max_abs_err": errs["wgmma"], **wgmma},
        {"name": "flash_attention_simt", **entry,
         "launches": launches["flash_attention_simt"],
         "max_abs_err": errs["simt"], **simt}]


# ---------------------------------------------------------------------------
# Phases 10-14: the training path and its kernels
# ---------------------------------------------------------------------------

# Training phase (13): the modes in the order they run, with their steps.
TRAIN_MODES = (("partitioned", 6), ("bulk", 2), ("per_leaf", 2))
TRAIN_AGGR = 1 << 20  # launch/train.py's default --aggr-bytes
# Step-0 loss of llama3.2-1b at init: ln(128256) = 11.76 plus about 0.5
# from tied-head logits of std ~1 (embeddings of std 1/sqrt(d) against
# a unit-RMS final state).
LOSS0_RANGE = (11.7, 12.8)
# CPU against the card on the smoke config: the tolerances of the CPU
# tests against JAX (tests/multidev_scripts/check_earlybird.py).
TRAIN_GRAD_TOL = (2e-4, 2e-5)   # rtol, atol
TRAIN_LOSS_RTOL = 1e-5


def _bits(t):
    """A view of ``t``'s bits, for bitwise comparison."""
    import torch
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return t.view(view[t.dtype]) if t.dtype in view else t


def _same_bits(a, b) -> bool:
    import torch
    return a.dtype == b.dtype and a.shape == b.shape \
        and torch.equal(_bits(a), _bits(b))


def _seeded(shape, dtype, dev, seed, scale=1.0):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


def _bucket_shapes(small: bool):
    """(d_model, one layer's wk shape, layers) of the llama3.2-1b buckets
    (cut for a CPU rehearsal)."""
    return (256, (256, 2, 16), 4) if small else (2048, (2048, 8, 64), 16)


def _bulk_bucket(dev, small: bool):
    """The 64 MiB bulk-mode bucket [final_norm, layers.attn.wk] as its 17
    segments, and the partitioned-mode [ln1, ln2] bucket (16 KiB)."""
    import torch
    d, wk, n_layers = _bucket_shapes(small)
    bulk = [_seeded((d,), torch.float32, dev, 99)] + [
        _seeded(wk, torch.float32, dev, 100 + i) for i in range(n_layers)]
    ln = [_seeded((d,), torch.float32, dev, 1),
          _seeded((d,), torch.float32, dev, 2)]
    return bulk, ln


def _odd_views(dtype, dev, sizes, seed):
    """Contiguous views of one seeded buffer at odd element offsets
    (1, 3, 5, ...), 16 elements apart."""
    offs = [sum(sizes[:i]) + 16 * i + 2 * i + 1 for i in range(len(sizes))]
    buf = _seeded((offs[-1] + sizes[-1] + 1,), dtype, dev, seed)
    return [buf[o:o + n] for o, n in zip(offs, sizes)]


def pack_phase(dev, small: bool = False) -> float:
    """Phase 11: bucket pack/unpack against their plain versions, bit for
    bit: every f32/bf16 pair at sizes 1, 13, 127, 128 and 129, scalar
    leaves, 300 leaves of mixed dtype, a stacked leaf of 16 segments, the
    64 MiB bulk bucket, the [ln1, ln2] bucket, segments that are views at
    odd element offsets (every pair; unpacked from a bucket view at an
    odd offset into views at odd offsets), a bf16 bucket whose segments
    sit at odd offsets, a bucket above the by-value capacity (the
    device-table route), and the round trip.  Returns the largest
    |difference| (0.0 when all are bitwise)."""
    import torch
    from repro_torch.kernels import bucket_pack as bp
    from repro_torch.kernels import ops
    F32, BF16 = torch.float32, torch.bfloat16
    on_card = dev.type == "cuda"
    cases = []  # (name, segments, bucket dtype, unpack into odd views)
    for sd in (F32, BF16):
        for bd in (F32, BF16):
            cases.append((f"{str(sd)[6:]}->{str(bd)[6:]}",
                          [_seeded((n,), sd, dev, n)
                           for n in (1, 13, 127, 128, 129)], bd, False))
    cases.append(("scalars", [_seeded((), F32, dev, i) for i in range(3)]
                  + [_seeded((5,), BF16, dev, 9)], F32, False))
    cases.append(("300 leaves", [
        _seeded(((7 * i) % 131 + 1,), BF16 if i % 3 == 0 else F32, dev, i)
        for i in range(300)], F32, False))
    bulk, ln = _bulk_bucket(dev, small)
    cases += [("stacked leaf, 16 segments", bulk[1:], F32, False),
              ("bulk bucket", bulk, F32, False),
              ("[ln1, ln2]", ln, F32, False)]
    odd = (1, 13, 127, 128, 129, 4099, 70001)
    for sd in (F32, BF16):
        for bd in (F32, BF16):
            cases.append((f"odd-offset views {str(sd)[6:]}->{str(bd)[6:]}",
                          _odd_views(sd, dev, odd, 11), bd, True))
    cases.append(("bf16 bucket, odd offsets", [
        _seeded((n,), F32, dev, 20 + n) for n in (13, 127, 129, 4099, 70001)],
        BF16, True))
    cap = bp.capacity() if on_card else 1016
    cases.append((f"{cap + 1} segments, above the by-value capacity",
                  [_seeded((i % 37 + 1,), F32, dev, i)
                   for i in range(cap + 1)], F32, False))
    err = 0.0
    for name, segs, bd, shifted in cases:
        routes = dict(bp.ROUTES)
        flat = ops.bucket_pack(segs, bd)
        want = bp.bucket_pack_plain(segs, bd)
        src = flat
        if shifted:  # the bucket read from a view at an odd offset
            src = torch.empty(flat.numel() + 4, dtype=bd, device=dev)[
                3:3 + flat.numel()]
            src.copy_(flat)
            outs = [o.zero_() for o in _odd_views(
                segs[0].dtype, dev, [s.numel() for s in segs], 12)]
        else:
            outs = [torch.empty_like(s) for s in segs]
        ops.bucket_unpack(src, segs, out=outs)
        fresh = ops.bucket_unpack(src, segs)
        back = bp.bucket_unpack_plain(want, segs)
        _sync(dev)
        check(_same_bits(flat, want),
              f"pack {name}: kernel differs from bucket_pack_plain")
        check(all(_same_bits(o, w) and _same_bits(f, w)
                  for o, f, w in zip(outs, fresh, back)),
              f"unpack {name}: kernel differs from bucket_unpack_plain")
        if bd == F32:  # f32 holds every f32 and bf16 value: exact trip
            check(all(_same_bits(o, s) for o, s in zip(outs, segs)),
                  f"round trip {name} is not exact")
        above = len(segs) > cap
        check(not on_card or bp.ROUTES["table" if above else "by_value"]
              - routes["table" if above else "by_value"] == 3,
              f"{name}: launches took the wrong descriptor route")
        err = max(err, float((flat.float() - want.float()).abs().max()))
    print(f"bucket pack/unpack vs plain: {len(cases)} cases bitwise equal"
          f" (4 dtype pairs, scalars, 300 leaves, 16-segment stacked leaf,"
          f" {sum(s.numel() for s in bulk) * 4} B bulk bucket, [ln1, ln2],"
          f" odd-offset views in 4 pairs, bf16 bucket at odd offsets,"
          f" {cap + 1} segments on the device-table route), round trips"
          f" exact, max_abs_err={err!r}; by-value capacity {cap}")
    return err


def _quant_check(x, name):
    """Kernel against plain, bit for bit, on ``x`` (its route from
    ``quant8.route``) and on the int8 values dequantized as they are (the
    vec route) and from a copy at an odd offset (the scalar route); one
    launch a call on the card.  The round
    trip within half a scale in blocks of finite scale; in the others
    JAX's semantics: scale NaN where the block holds a NaN, infinite
    where it holds an infinity and no NaN, every value 0.  Returns the
    values, the scales and the largest |difference| at finite values."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant8 as q8
    on_card = x.device.type == "cuda"
    n = x.numel()
    qv = torch.empty(n + 1, dtype=torch.int8, device=x.device)[1:]
    calls = []
    for fn, args, route in (
            (ops.quantize_blockwise, (x,), q8.route(x)),
            (ops.dequantize_blockwise, None, "vec"),
            (ops.dequantize_blockwise, None, "scalar")):
        launches, routes = dict(q8.LAUNCHES), dict(q8.ROUTES)
        if args is None:  # the values, then their copy at an odd offset
            if route == "scalar":
                qv.copy_(calls[0][0])
            args = (calls[0][0] if route == "vec" else qv, calls[0][1])
        calls.append(fn(*args))
        grew = sum(q8.LAUNCHES.values()) - sum(launches.values())
        took = [k for k in routes if q8.ROUTES[k] != routes[k]]
        check(not on_card or (grew == 1 and took == [route]),
              f"quant8 {name}: {fn.__name__} made {grew} launches on"
              f" routes {took}, want one on {route!r}")
    (q, s), y, yv = calls
    qw, sw = q8.quantize_blockwise_plain(x)
    yw = q8.dequantize_blockwise_plain(qw, sw)
    if on_card:
        torch.cuda.synchronize()
    check(_same_bits(q, qw), f"quant8 {name}: int8 values differ")
    check(_same_bits(s, sw), f"quant8 {name}: scales differ")
    check(_same_bits(y, yw), f"quant8 {name}: dequantized values differ")
    check(_same_bits(yv, yw),
          f"quant8 {name}: dequantized values at an odd offset differ")
    xb = F.pad(x.float(), (0, (-n) % q8.BLOCK)).view(-1, q8.BLOCK)
    has_nan = xb.isnan().any(1)
    check(torch.equal(s.isnan(), has_nan) and torch.equal(
        s.isinf(), xb.isinf().any(1) & ~has_nan),
        f"quant8 {name}: NaN and inf scales not where the blocks hold them")
    fin = s.isfinite().repeat_interleave(q8.BLOCK)[:n]
    check(not q[~fin].any(), f"quant8 {name}: nonzero values in a block"
          f" of NaN or infinite scale")
    bound = s.repeat_interleave(q8.BLOCK)[:n] * 0.5
    check(bool(((y - x.float()).abs() <= bound * 1.001 + 1e-30)[fin].all()),
          f"quant8 {name}: round trip beyond half a scale")
    finite = y.isfinite()
    return q, s, float((y - yw)[finite].abs().max()) if finite.any() else 0.0


def quant_phase(dev, small: bool = False) -> float:
    """Phase 12: quantize/dequantize against their plain versions, bit for
    bit in the values, the scales and the dequantized values
    (``_quant_check``: also dequantized from a copy at an odd offset, one
    launch a call on the route its input picks): n = 1, 255, 256, 257
    and 2^24 + 100 heavy-tailed normals, an all-zero block, magnitudes
    1e-6 and 1e4, exact k + 1/2 ties built from the scale, the round trip
    within half a scale; blocks with a NaN, +inf, -inf, NaN and inf, and
    a NaN in the ragged tail; bf16 inputs (2^24 + 100 and ragged); views
    of x at odd element offsets (f32 and bf16, the scalar route).
    Returns the largest |difference| at finite values."""
    import torch
    big = (1 << 16) + 100 if small else (1 << 24) + 100
    err = 0.0

    def heavy(n, seed):
        return _seeded((n,), torch.float32, dev, seed) * \
            torch.exp(_seeded((n,), torch.float32, dev, seed + 1))
    for n in (1, 255, 256, 257, big):
        x = heavy(n, n)
        if n == big:
            x[256:512] = 0.0  # an all-zero block
        err = max(err, _quant_check(x, f"n={n}")[2])
    for scale in (1e-6, 1e4):
        err = max(err, _quant_check(
            _seeded((4096 + 3,), torch.float32, dev, 5, scale),
            f"magnitude {scale}")[2])
    # max 127/64 -> scale 1/64 exactly; (k + 1/2) / 64 is a tie
    k = torch.arange(-126, 126, dtype=torch.float32, device=dev)
    tie = torch.cat([torch.tensor([127.0], device=dev), k + 0.5,
                     torch.tensor([-3.0, 1.0, 2.0], device=dev)]) / 64.0
    q, s, e = _quant_check(tie, "ties")
    check(float(s[0]) == 1.0 / 64.0 and torch.equal(
        q[1:253].long(), torch.round(k + 0.5).long()),
        "quant8 ties: not rounded half to even")
    err = max(err, e)
    # non-finite blocks, what JAX gives: scales NaN / inf, values 0
    nonfinite = heavy(big, 7)
    for i, v in ((300, "nan"), (600, "inf"), (900, "-inf"), (1100, "nan"),
                 (1101, "inf"), (big - 1, "nan")):
        nonfinite[i] = float(v)
    q, s, e = _quant_check(nonfinite, "non-finite")
    check(bool(s[[1, 4, -1]].isnan().all() and s[2:4].isposinf().all()
               and not q[256:1280].any()),
          "quant8 non-finite: not JAX's scales [nan, inf, inf, nan] and"
          " zeros")
    err = max(err, e)
    p = _nonfinite_probe(dev)
    err = max(err, _quant_check(p, "probe NaN / +inf")[2])
    for n in (big, 4096 + 3):
        err = max(err, _quant_check(heavy(n, 11).to(torch.bfloat16),
                                    f"bf16 n={n}")[2])
    for dtype in (torch.float32, torch.bfloat16):  # unaligned x
        for off in (1, 3):
            x = nonfinite[:4096 + 3 + off].to(dtype)[off:]
            err = max(err, _quant_check(x, f"{dtype} view at +{off}")[2])
    print(f"quant8 vs plain: n in (1, 255, 256, 257, {big}), zero block,"
          f" magnitudes 1e-6 and 1e4, 252 exact ties, NaN/+inf/-inf"
          f" blocks and a NaN in the ragged tail (scales nan and inf,"
          f" values 0, as JAX), bf16 at n={big} and 4099, f32 and bf16"
          f" views at offsets 1 and 3, each also dequantized from an odd"
          f" offset (scalar route): values, scales and dequantized values"
          f" bitwise equal, one launch a call on its route, round trips"
          f" within half a scale,"
          f" max_abs_err={err!r}")
    return err


def _expected_packs(model, mode: str, aggr: int) -> int:
    """Multi-leaf buckets of one step's sync: the pack (and unpack)
    launches the plan asks for."""
    from repro_torch.core import bucketing
    from repro_torch.models import lm

    def multi(leaves, a):
        plan = bucketing.make_plan([s for _, s in leaves], a)
        return sum(len(b.leaf_ids) > 1 for b in plan.buckets)
    leaves = lm.param_leaves(model.named_parameters())
    if mode == "partitioned":
        rest = [lf for lf in leaves if not lf[0].startswith("layers.")]
        return multi(rest, aggr) + sum(
            multi(lm.param_leaves(lp.named_parameters()), aggr)
            for lp in model.layers)
    return multi(leaves, 256 << 20 if mode == "bulk" else 0)


def _expected_all_reduces(model, mode: str, aggr: int) -> int:
    """All-reduces of one step's sync: one per bucket of the plan, as the
    JAX package issues them (a stacked leaf is one), plus the loss's."""
    from repro_torch.core import bucketing
    from repro_torch.models import lm

    def buckets(leaves, a):
        return bucketing.make_plan([s for _, s in leaves], a).n_buckets
    leaves = lm.param_leaves(model.named_parameters())
    if mode == "partitioned":
        rest = [lf for lf in leaves if not lf[0].startswith("layers.")]
        return 1 + buckets(rest, aggr) + sum(
            buckets(lm.param_leaves(lp.named_parameters()), aggr)
            for lp in model.layers)
    return 1 + buckets(leaves, 256 << 20 if mode == "bulk" else 0)


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def training_phase(dev, small: bool = False) -> dict:
    """Phase 13: the training path, llama3.2-1b at full width and depth in
    f32 (random weights from seed 0), 4 x 1024 tokens a step, through
    ``make_train_step`` on the one-rank group: partitioned for 6 steps,
    bulk and per_leaf for 2, each from the same weights and batches.
    Checks the step-0 loss band, finite losses, pack/unpack launches per
    step against the plan, and equal step-0 losses and synced gradients
    across the modes; then the smoke config trained 3 steps on the CPU
    and on the card.  Returns what phase 14 and the kernel table need."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import pipeline
    from repro_torch.kernels import bucket_pack as bp
    from repro_torch.kernels import quant8 as q8
    from repro_torch.launch import steps

    arch = "llama3.2-1b"
    cfg = (get_smoke_config if small else get_config)(arch).replace(
        param_dtype="float32")
    batch, seq = (4, 64) if small else (4, 1024)
    stream = pipeline.for_model(cfg, seq, batch)
    n_max = max(n for _, n in TRAIN_MODES)
    batches = [steps.batch_to_device(stream.batch(i), dev)
               for i in range(n_max + 1)]
    on_card = dev.type == "cuda"
    out = {"cfg": cfg, "tokens": batch * seq, "modes": {}}
    grads0 = None
    for k in bp.LAUNCHES:
        bp.LAUNCHES[k] = 0
    for k in bp.ROUTES:
        bp.ROUTES[k] = 0
    for k in q8.LAUNCHES:
        q8.LAUNCHES[k] = 0
    t_main = time.perf_counter()
    for mode, n_steps in TRAIN_MODES:
        scfg = steps.StepConfig(sync_mode=mode, aggr_bytes=TRAIN_AGGR,
                                param_dtype="float32", warmup_steps=1,
                                total_steps=n_max)
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        state = steps.build_state(cfg, 0, dev, scfg.adam)
        step = steps.make_train_step(cfg, scfg, seq_len=seq, batch=batch,
                                     device=dev)
        want = _expected_packs(state["params"], mode, TRAIN_AGGR)
        want_ar = _expected_all_reduces(state["params"], mode, TRAIN_AGGR)
        losses, times, packs, n_ar = [], [], [], []
        for i in range(n_steps):
            before = dict(bp.LAUNCHES)
            _sync(dev)
            t0 = time.perf_counter()
            state, loss = step(state, batches[i])
            losses.append(loss.item())
            _sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            packs.append((bp.LAUNCHES["bucket_pack"] - before["bucket_pack"],
                          bp.LAUNCHES["bucket_unpack"]
                          - before["bucket_unpack"]))
            n_ar.append(step.log.count())
            if i == 0:  # step-0 synced gradients, kept on the host
                g = {n: p.grad.cpu() for n, p in
                     state["params"].named_parameters()}
                if grads0 is None:
                    grads0 = g
                    loss0 = losses[0]
                else:
                    diff = [(n, float(((t - grads0[n]).abs()
                                       / grads0[n].abs().clamp_min(1e-30))
                                      .max()))
                            for n, t in g.items()
                            if not torch.equal(t, grads0[n])]
                    out["modes"][mode] = {"grad_diff": diff}
                    check(not diff or max(d for _, d in diff) <= 1e-6,
                          f"{mode}: step-0 gradients differ from"
                          f" partitioned beyond 1e-6 relative: {diff[:3]}")
                    check(losses[0] == loss0,
                          f"{mode}: step-0 loss {losses[0]!r} !="
                          f" partitioned {loss0!r}")
        check(all(np.isfinite(losses)), f"{mode}: non-finite loss {losses}")
        if not small:
            check(LOSS0_RANGE[0] <= losses[0] <= LOSS0_RANGE[1],
                  f"{mode}: step-0 loss {losses[0]!r} outside {LOSS0_RANGE}")
        check(not on_card or all(p == (want, want) for p in packs),
              f"{mode}: pack/unpack launches per step {packs}, the plan"
              f" has {want} multi-leaf buckets")
        check(all(c == want_ar for c in n_ar),
              f"{mode}: all-reduces per step {n_ar}, the plan has"
              f" {want_ar - 1} buckets and the loss one")
        rec = out["modes"].setdefault(mode, {"grad_diff": []})
        rec.update(losses=losses, times_ms=times, packs=packs,
                   plan_multi=want, n_all_reduce=n_ar,
                   plan_all_reduce=want_ar,
                   peak_gib=(torch.cuda.max_memory_allocated(dev) / 2**30
                             if on_card else None))
        if on_card:  # one more step, under the profiler
            rec["profile"] = _device_split(
                lambda: step(state, batches[n_steps]), dev)
        del state, step
        if on_card:
            torch.cuda.empty_cache()
    out["launches"] = {**bp.LAUNCHES, **q8.LAUNCHES}
    out["routes"] = dict(bp.ROUTES)
    out["main_s"] = time.perf_counter() - t_main
    del grads0
    for mode, rec in out["modes"].items():
        ms = sorted(rec["times_ms"][1:]) or rec["times_ms"]
        rec["step_ms"] = ms[len(ms) // 2]
        rec["tokens_per_s"] = out["tokens"] / (rec["step_ms"] / 1e3)
        print(f"train {cfg.name} {mode}: losses {rec['losses']}, pack/unpack"
              f" launches per step {rec['packs']} (plan: {rec['plan_multi']}"
              f" multi-leaf buckets), all-reduces per step"
              f" {rec['n_all_reduce']} (plan: {rec['plan_all_reduce'] - 1}"
              f" buckets + the loss), step-0 gradients vs partitioned:"
              f" {'bitwise equal' if not rec['grad_diff'] else rec['grad_diff'][:3]},"
              f" step ms {[round(t, 3) for t in rec['times_ms']]}")
    check(not on_card or out["launches"]["bucket_pack"] > 0,
          "the training path launched no pack kernel")
    check(out["routes"]["table"] == 0,
          "a bucket of the training path took the device-table route")
    print(f"training main path: launches {out['launches']}, descriptor"
          f" routes {out['routes']} over"
          f" {sum(n + on_card for _, n in TRAIN_MODES)} steps,"
          f" {out['main_s']:.3f} s")
    if on_card:
        out["cpu_vs_card"] = _cpu_vs_card(dev)
    return out


def _cpu_vs_card(dev) -> dict:
    """The smoke config trained 3 steps from the same weights and batches
    on the CPU (its own gloo group) and on the card: losses within
    ``TRAIN_LOSS_RTOL``, step-0 synced gradients within
    ``TRAIN_GRAD_TOL``."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    cfg = get_smoke_config("llama3.2-1b").replace(param_dtype="float32")
    scfg = steps.StepConfig(sync_mode="partitioned", aggr_bytes=1 << 12,
                            param_dtype="float32", warmup_steps=1,
                            total_steps=6)
    stream = pipeline.for_model(cfg, 64, 4)
    card = steps.build_state(cfg, 0, dev)
    cpu = steps.build_state(cfg, 0, "cpu")
    with torch.no_grad():
        for (_, a), (_, b) in zip(cpu["params"].named_parameters(),
                                  card["params"].named_parameters()):
            a.copy_(b.cpu())
    runs = {}
    for name, st, d, group in (("card", card, dev, None),
                               ("cpu", cpu, torch.device("cpu"),
                                dist.new_group(backend="gloo"))):
        step = steps.make_train_step(cfg, scfg, seq_len=64, batch=4,
                                     group=group, device=d)
        losses, g0 = [], None
        for i in range(3):
            st, loss = step(st, steps.batch_to_device(stream.batch(i), d))
            losses.append(loss.item())
            if i == 0:
                g0 = {n: p.grad.detach().cpu().clone()
                      for n, p in st["params"].named_parameters()}
        runs[name] = (losses, g0)
    (lc, gc), (lh, gh) = runs["card"], runs["cpu"]
    rtol, atol = TRAIN_GRAD_TOL
    gerr = max(float(((gc[n] - gh[n]).abs()
                      - rtol * gh[n].abs()).max()) for n in gh)
    lerr = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    print(f"train smoke cpu vs card, 3 steps: losses card {lc} cpu {lh}"
          f" (max rel {lerr!r}, tol {TRAIN_LOSS_RTOL}); step-0 gradients"
          f" max(|d| - {rtol}|g|) = {gerr!r} (tol {atol})")
    check(lerr <= TRAIN_LOSS_RTOL, "smoke training: cpu and card losses differ")
    check(gerr <= atol, "smoke training: cpu and card gradients differ")
    return {"loss_rel": lerr, "grad_excess": gerr}


def _bytes_bound(nbytes: int):
    """(bound ms, "bytes") of a kernel that only moves ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def train_times(dev, train: dict, errs: dict, small: bool = False) -> list:
    """Phase 14: CUDA-event medians of the pack kernels at the 64 MiB bulk
    bucket and the 16 KiB [ln1, ln2] bucket beside their plain versions
    and one PyTorch call for the same function (``torch.cat`` of the
    flattened leaves; ``torch._foreach_copy_`` into the leaves, which
    unpack writes back into as the main path does), timed
    with the flattening views made inside the timed call and, for the
    table's ``library_ms``, beforehand; the kernels' host enqueue times;
    device time per call of the kernels and the two library calls from
    ``torch.profiler``, whose trace of 10 pack and 10 unpack calls per
    bucket must hold all 20 kernels and no host-to-device copy; medians of
    quantize (f32 and bf16) and dequantize at 2^24 elements beside their
    plain versions, with host enqueue and profiler device time (10 calls,
    10 kernels, no host-to-device copy), dequantize also beside
    ``torch.mul`` of the int8 values and their scales (checked bitwise
    equal; window and device time), each with its bound in bytes at
    3.35 TB/s; the train step per mode
    and the profile of one partitioned step.  Returns the four kernels'
    table entries."""
    import torch
    from repro_torch.kernels import bucket_pack as bp
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant8 as q8
    reps = 20 if dev.type == "cuda" else 3
    bulk, ln = _bulk_bucket(dev, small)
    rows = {}
    for name, segs in (("bulk", bulk), ("ln1_ln2", ln)):
        flat = ops.bucket_pack(segs)
        # unpack writes back into the segments it was packed from, as
        # bucketed_apply does (the same values)
        outs = segs
        sizes = [s.numel() for s in segs]
        nbytes = 2 * flat.numel() * flat.element_size()
        foreach = getattr(torch, "_foreach_copy_", None)
        flats = [s.reshape(-1) for s in segs]
        views = [p.view_as(o) for p, o in zip(flat.split(sizes), outs)]
        rows[name] = {
            "pack": (_timed(lambda: ops.bucket_pack(segs), dev, reps),
                     _timed(lambda: bp.bucket_pack_plain(segs), dev, reps),
                     _timed(lambda: torch.cat([s.reshape(-1) for s in segs]),
                            dev, reps)),
            "unpack": (_timed(lambda: ops.bucket_unpack(flat, segs, out=outs),
                              dev, reps),
                       _timed(lambda: bp.bucket_unpack_plain(flat, segs,
                                                             out=outs),
                              dev, reps),
                       None if foreach is None else _timed(
                           lambda: foreach(outs, [
                               p.view_as(o) for p, o in
                               zip(flat.split(sizes), outs)]), dev, reps)),
            "bound": _bytes_bound(nbytes), "bytes": nbytes,
            # the two library calls alone, their views made beforehand
            "ready": (_timed(lambda: torch.cat(flats), dev, reps),
                      None if foreach is None else _timed(
                          lambda: foreach(outs, views), dev, reps)),
            "host": (_host_ms(lambda: ops.bucket_pack(segs), dev, reps),
                     _host_ms(lambda: ops.bucket_unpack(flat, segs,
                                                        out=outs),
                              dev, reps))}
        if dev.type == "cuda":  # device time per call, and no HtoD copy
            prof = [_device_profile(fn, expect=want) for fn, want in (
                (lambda: ops.bucket_pack(segs), 10),
                (lambda: ops.bucket_unpack(flat, segs, out=outs), 10),
                (lambda: torch.cat(flats), None),
                (lambda: foreach(outs, views), None))]
            print(f"profile pack/unpack {name} bucket, 10 calls each after"
                  f" a dropped warm-up step: device ms per call pack kernel"
                  f" {prof[0][0]!r}, unpack kernel {prof[1][0]!r},"
                  f" torch.cat {prof[2][0]!r}, torch._foreach_copy_"
                  f" {prof[3][0]!r}; the kernels' device events"
                  f" {prof[0][3]} and {prof[1][3]}; HtoD memcpy events"
                  f" {prof[0][2]} and {prof[1][2]}")
            for (_, events, htod, names), what in zip(prof, ("pack",
                                                            "unpack")):
                check(events == 10 and all("bucket_kernel" in k
                                           for k, _ in names),
                      f"{what} {name}: 10 calls did not trace 10 kernels")
                check(htod == 0,
                      f"{what} {name}: the calls issued HtoD copies")
        print(f"times pack/unpack {name} bucket ({len(segs)} segments,"
              f" {flat.numel() * 4} B f32): pack kernel"
              f" {rows[name]['pack'][0]:.4f} ms, plain"
              f" {rows[name]['pack'][1]:.4f} ms, torch.cat"
              f" {rows[name]['pack'][2]:.4f} ms; unpack kernel"
              f" {rows[name]['unpack'][0]:.4f} ms, plain"
              f" {rows[name]['unpack'][1]:.4f} ms, torch._foreach_copy_"
              f" {rows[name]['unpack'][2]!r} ms; bound"
              f" {rows[name]['bound'][0]:.5f} ms ({nbytes} bytes each);"
              f" with their views made beforehand torch.cat"
              f" {rows[name]['ready'][0]:.4f} ms, torch._foreach_copy_"
              f" {rows[name]['ready'][1]!r} ms; host enqueue pack"
              f" {rows[name]['host'][0]:.4f} ms, unpack"
              f" {rows[name]['host'][1]:.4f} ms")
    n = (1 << 16) if small else (1 << 24)
    x = _seeded((n,), torch.float32, dev, 3)
    xb = x.to(torch.bfloat16)
    q, s = ops.quantize_blockwise(x)
    nb = s.numel()

    def lib_mul():
        return torch.mul(q.view(-1, q8.BLOCK), s[:, None])
    # name: (call, plain, bound, library call, kernel name in a trace)
    cases = {
        "quantize_blockwise": (
            lambda: ops.quantize_blockwise(x),
            lambda: q8.quantize_blockwise_plain(x),
            _bytes_bound(4 * n + n + 4 * nb), None, "quant_kernel"),
        "quantize_blockwise_bf16": (
            lambda: ops.quantize_blockwise(xb),
            lambda: q8.quantize_blockwise_plain(xb),
            _bytes_bound(2 * n + n + 4 * nb), None, "quant_bf16_vec_kernel"),
        "dequantize_blockwise": (
            lambda: ops.dequantize_blockwise(q, s),
            lambda: q8.dequantize_blockwise_plain(q, s),
            _bytes_bound(n + 4 * nb + 4 * n), lib_mul, "dequant_kernel")}
    # the library call is the same function: int8 -> f32, one rounding
    check(_same_bits(lib_mul().reshape(-1), ops.dequantize_blockwise(q, s)),
          "torch.mul(q, scale) differs from the dequantize kernel")
    quant = {}
    for name, (fn, plain, (bound, by), lib, kernel) in cases.items():
        rec = quant[name] = {
            "ms": _timed(fn, dev, reps), "plain_ms": _timed(plain, dev, reps),
            "bound_ms": bound, "bound_by": by,
            "library_ms": None if lib is None else _timed(lib, dev, reps),
            "enqueue_ms": _host_ms(fn, dev, reps),
            "device_ms": None, "library_device_ms": None}
        if dev.type == "cuda":  # 10 calls, 10 kernels, no HtoD copy
            rec["device_ms"] = _quant_device(fn, kernel)
            if lib is not None:
                rec["library_device_ms"] = _device_profile(lib)[0]
        print(f"times {name} n={n}: kernel {rec['ms']:.4f} ms (event"
              f" window), device {rec['device_ms']!r} ms a call (10 calls,"
              f" 10 kernels, no HtoD copy), host enqueue"
              f" {rec['enqueue_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms,"
              f" bound {bound:.5f} ms, library "
              + ("none" if lib is None else
                 f"{rec['library_ms']:.4f} ms, device"
                 f" {rec['library_device_ms']!r} ms (torch.mul)"))
    dq = quant["dequantize_blockwise"]
    if dev.type == "cuda":
        slower = [w for w, a, b in (
            ("window", dq["ms"], dq["library_ms"]),
            ("device", dq["device_ms"], dq["library_device_ms"])) if a > b]
        print(f"dequantize vs torch.mul: window {dq['ms']:.4f} /"
              f" {dq['library_ms']:.4f} ms, device {dq['device_ms']:.4f} /"
              f" {dq['library_device_ms']:.4f} ms: "
              + (f"slower in {slower}" if slower else "no slower in either"))
    for mode, rec in train["modes"].items():
        print(f"times train {train['cfg'].name} {mode}: step"
              f" {rec['step_ms']:.3f} ms (median after step 0),"
              f" {rec['tokens_per_s']:.1f} tokens/s, peak memory"
              f" {rec['peak_gib']!r} GiB")
        if "profile" in rec:
            wall, busy, events, evs = rec["profile"]
            tops = ", ".join(f"{k[:48]} {t:.3f} ms" for t, k, _ in evs[:4])
            sync = {w: (sum(t for t, k, _ in evs if w in k.lower()),
                        sum(c for _, k, c in evs if w in k.lower()))
                    for w in ("nccl", "bucket_kernel", "memcpy", "htod")}
            print(f"profile train step ({mode}): wall {wall:.3f} ms, device"
                  f" busy {busy:.3f} ms, idle share {1 - busy / wall:.3f},"
                  f" {events} device events; top: {tops}; (device ms,"
                  f" events) of nccl / pack kernels / memcpy / HtoD"
                  f" memcpy: {sync}")
    entries = []
    src = "src/repro_torch/csrc/"
    for name, line, key, i in (("bucket_pack", 76, "pack", 0),
                               ("bucket_unpack", 111, "unpack", 1)):
        ms, plain, _ = rows["bulk"][key]
        lib = rows["bulk"]["ready"][i]  # one library call, nothing else
        entries.append({
            "name": name, "route": "cuda", "source": src + "bucket_pack.cu",
            "replaces": f"src/repro/kernels/bucket_pack.py:{line}",
            "launches": train["launches"][name], "max_abs_err": errs["pack"],
            "ms": ms, "plain_ms": plain, "bound_ms": rows["bulk"]["bound"][0],
            "bound_by": "bytes", "library_ms": lib})
    for name, line in (("quantize_blockwise", 59),
                       ("dequantize_blockwise", 80)):
        rec = quant[name]
        entries.append({
            "name": name, "route": "cuda", "source": src + "quant8.cu",
            "replaces": f"src/repro/kernels/quant8.py:{line}",
            "launches": train["launches"][name], "max_abs_err": errs["quant"],
            **{k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "device_ms",
                                   "enqueue_ms")}})
    return entries


def _device_profile(fn, n: int = 10, expect=None):
    """Device ms per call, device events and host-to-device copies of
    ``n`` calls of ``fn`` under ``torch.profiler``, after a warm-up step
    that the profiler traces and drops (a trace may lose the first events
    after it starts).  Also the device events' names and counts.  A trace
    can still lose events: where the caller knows how many device events
    the ``n`` calls make (``expect``), a trace holding another count is
    taken again, up to three traces, and the last one is returned (the
    caller checks its count)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(3):
        torch.cuda.synchronize()
        traced = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: traced.append(
                         p.key_averages())) as prof:
            for _ in range(2):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        evs = [(e.key, e.count, e.self_device_time_total / 1e3)
               for e in traced[-1]
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if expect is None or sum(c for _, c, _ in evs) == expect:
            break
    return (sum(t for _, _, t in evs) / n, sum(c for _, c, _ in evs),
            sum(c for k, c, _ in evs if "htod" in k.lower()),
            [(k[:60], c) for k, c, _ in evs])


def _flash_build_report(build, lib_path) -> None:
    """Each flash kernel's registers and spills from the ``-Xptxas -v``
    log, and the tensor-core (HGMMA) and TMA-load (UTMALDG) instructions
    in the wgmma kernels' SASS; fails if the wgmma kernel has none."""
    log = build.log_path("flash_attention").read_text()
    for m in re.finditer(r"Compiling entry function '(\S+)'.*?\n(.*?)"
                         r"Used (\d+) registers", log, re.S):
        inst = re.search(r"flash_wgmma_kernelILi(\d+)E", m.group(1))
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill"
                          r" loads", m.group(2))
        if inst:
            print(f"ptxas flash_wgmma_kernel<NC={inst.group(1)}>:"
                  f" {m.group(3)} registers at entry (setmaxnreg: 240 in"
                  f" the consumers), spill stores {spill.group(1)},"
                  f" loads {spill.group(2)} bytes")
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True,
                          check=True).stdout
    per_fn = re.split(r"\n\s*Function : ", sass)
    wg = [f for f in per_fn if f.split("\n", 1)[0].find("flash_wgmma") >= 0]
    counts = [(len(re.findall(r"\bHGMMA\.", f)),
               len(re.findall(r"\bUTMALDG\b", f))) for f in wg]
    print(f"sass flash_wgmma_kernel: {len(wg)} instances, (HGMMA, UTMALDG)"
          f" each {counts}")
    check(len(wg) == 4 and all(h > 0 and t > 0 for h, t in counts),
          "the wgmma flash kernel's SASS lacks HGMMA or UTMALDG")


# Phase 15: the paper's scenarios.  The thirteen specs whose full grids
# run on engine cuda, and the fabric kernel's launches each must make
# under the default adaptive cutoffs: 0 is the reference's routing (one
# flow runs the scalar path; drops take the NumPy faulty fabric; the
# other batches are too narrow), halo1d launches at 16 ranks and faults
# on its fault-free 4x4 torus.
SCENARIO_LAUNCHES = {
    "fig4_latency": 0, "fig5_contention": 0, "fig6_vci": 0,
    "fig7_aggregation": 0, "fig8_earlybird": 0, "halo1d": 3,
    "steady_state": 0, "imbalance": 0, "serving": 0, "faults": 3,
    "membership": 0, "serving_faults": 0, "recovery": 0}
# The batched drivers run again with the cutoffs at 0, each smoke record
# against engine reference on the fields every engine must reproduce
# exactly (the JAX package's differential table, plus membership's).
FORCED_FIELDS = {
    "simulate_halo": ("rank_tts_s", "n_messages", "time_s", "tts_s"),
    "simulate_imbalance": ("rank_tts_s", "mean_delay_s", "n_messages",
                           "time_s", "tts_s"),
    "simulate_serving": ("latency_s", "tts_s", "n_messages", "n_waves"),
    "simulate_faulty": ("rank_tts_s", "tts_s", "n_retransmits",
                        "retrans_bytes", "rounds", "n_messages"),
    "simulate_membership": ("iter_times_s", "epoch_starts", "quiesce_s",
                            "replan_s", "warmup_s", "tts_s", "n_messages",
                            "plan_data", "plan_model", "plan_dropped",
                            "grad_accum_factor"),
}
FORCED_SPECS = {"halo1d": "simulate_halo", "imbalance": "simulate_imbalance",
                "serving": "simulate_serving", "membership":
                "simulate_membership", "faults": "simulate_faulty"}
CHAOS_CAMPAIGNS = 32


def _fields_equal(a, b, fields) -> bool:
    import numpy as np
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               if isinstance(getattr(a, f), np.ndarray)
               else getattr(a, f) == getattr(b, f) for f in fields)


def scenarios_phase(dev, baseline: dict) -> dict:
    """Phase 15: the paper's evaluation on the card.  (a) the full grids
    of the thirteen scenario specs on engine cuda against the baseline,
    with the fabric kernel's launches over each; (b) the batched
    drivers' smoke records with the adaptive cutoffs at 0, bitwise
    against engine reference, at least one launch a record; (c) the
    Fig-5/Fig-6 crossover; (d) the chaos campaigns.  Returns the wall
    seconds and launches per spec."""
    import numpy as np
    from repro_torch.core import fabric as fb
    from repro_torch.core import fabric_cuda as fc
    from repro_torch.core import simulator as sim
    from repro_torch.experiments import (SPECS, compare_to_baseline,
                                         contention_crossover, run_spec)
    from repro_torch.experiments import chaos
    from repro_torch.experiments import engine as exp_engine

    on_card = dev.type == "cuda"
    calls = []
    real_scan = fc.fabric_scan

    def counted(ops):
        calls.append(ops.n)
        return real_scan(ops)

    def launched() -> int:  # the kernel's count on the card, calls here
        return fc.LAUNCHES["fabric_scan"] if on_card else len(calls)

    out, results = {}, {}
    fc.fabric_scan = counted
    try:
        # (a) full grids, cold, under the default cutoffs
        for name, want in SCENARIO_LAUNCHES.items():
            exp_engine._CACHE.clear()
            sim.clear_merge_memo()
            calls.clear()
            fc.LAUNCHES["fabric_scan"] = 0
            t0 = time.perf_counter()
            res = run_spec(SPECS[name], "full", engine="cuda", device=dev)
            wall = time.perf_counter() - t0
            n = launched()
            check(n == len(calls), f"{name}: {n} launches for"
                  f" {len(calls)} kernel calls")
            check(n == want, f"{name}: {n} fabric_scan launches, the"
                  f" reference's routing gives {want}")
            v = compare_to_baseline(baseline, {name: res})
            check(not v, f"{name} baseline drift: " + "; ".join(v))
            recs = baseline["specs"][name]["records"]
            for key, m in res.items():
                check(m["n_messages"] == recs[key]["n_messages"],
                      f"{name}/{key}: n_messages {m['n_messages']}")
                check(all(np.isfinite(x) for x in m.values()),
                      f"{name}/{key}: not finite")
            results[name] = res
            out[name] = {"records": len(res), "wall_s": wall, "launches": n}
            print(f"scenarios {name} full (cuda): {len(res)} records,"
                  f" 0 baseline violations, n_messages exact, wall"
                  f" {wall:.3f} s, fabric_scan launches {n}")
        total = sum(o["records"] for o in out.values())
        check(total == 155, f"scenario grids hold {total} records, not 155")

        # (b) the batched drivers with the cutoffs at 0
        cutoffs = fb.SCALAR_BATCH_CUTOFF, fb.MIN_GROUP_PARALLELISM
        fb.SCALAR_BATCH_CUTOFF = fb.MIN_GROUP_PARALLELISM = 0
        try:
            for name, driver in FORCED_SPECS.items():
                spec = SPECS[name]
                points = [p for p in spec.points("smoke")
                          if p.get("fault_rate", 0.0) == 0.0]
                got = []
                real_driver = getattr(sim, driver)

                def capture(*a, **k):
                    r = real_driver(*a, **k)
                    got.append(r)
                    return r
                setattr(sim, driver, capture)
                per_record = []
                t0 = time.perf_counter()
                try:
                    for p in points:
                        calls.clear()
                        fc.LAUNCHES["fabric_scan"] = 0
                        exp_engine.RUNNERS[spec.runner](p, engine="cuda",
                                                        device=dev)
                        per_record.append(launched())
                        exp_engine.RUNNERS[spec.runner](
                            p, engine="reference", device=dev)
                finally:
                    setattr(sim, driver, real_driver)
                wall = time.perf_counter() - t0
                for p, (a, b) in zip(points, zip(got[::2], got[1::2])):
                    check(_fields_equal(a, b, FORCED_FIELDS[driver]),
                          f"forced {name}/{exp_engine.record_key(p)}: cuda"
                          f" differs from reference")
                check(len(got) == 2 * len(points) and min(per_record) >= 1,
                      f"forced {name}: launches a record {per_record}")
                out[name]["forced_launches"] = per_record
                print(f"scenarios {name} smoke, cutoffs 0 (cuda vs"
                      f" reference): {len(points)} records bitwise on"
                      f" {len(FORCED_FIELDS[driver])} fields,"
                      f" fabric_scan launches a record {per_record},"
                      f" wall {wall:.3f} s")
        finally:
            fb.SCALAR_BATCH_CUTOFF, fb.MIN_GROUP_PARALLELISM = cutoffs
    finally:
        fc.fabric_scan = real_scan

    # (c) the Fig-5/Fig-6 crossover
    cross = contention_crossover({"fig6_vci": results["fig6_vci"]})
    for ap in ("part", "pt2pt_many"):
        lo, hi = (cross[ap]["slowdown_at_1_vcis"],
                  cross[ap]["slowdown_at_32_vcis"])
        check(lo > 10.0 and lo / hi > 10.0,
              f"crossover {ap}: {lo:.2f}x at 1 VCI, {hi:.2f}x at 32")
    check(cross["pt2pt_many"]["slowdown_at_32_vcis"] < 1.5
          and cross["part"]["slowdown_at_32_vcis"] < 6.0,
          f"crossover at 32 VCIs: {cross}")
    print("crossover vs pt2pt_single: " + "; ".join(
        f"{ap} " + ", ".join(f"{k}={v:.2f}x" for k, v in r.items())
        for ap, r in cross.items()))

    # (d) chaos campaigns, cuda against reference
    t0 = time.perf_counter()
    report = chaos.run_campaigns(CHAOS_CAMPAIGNS, engine="cuda", device=dev)
    wall = time.perf_counter() - t0
    check(report["n_violations"] == 0,
          "chaos: " + "; ".join(report["violations"][:5]))
    print(f"chaos: {CHAOS_CAMPAIGNS} campaigns (cuda vs reference,"
          f" {report['n_serving']} serving, policies"
          f" {report['by_policy']}), 0 violations, wall {wall:.3f} s")
    out["chaos_wall_s"] = wall
    return out


def run(device_name: str = "cuda", small: bool = False) -> dict:
    """All phases on ``device_name``; returns the kernel table.
    ``small`` cuts the serving and training phases to the llama smoke
    config and the flash, pack and quant8 cases to small sizes, for a
    rehearsal on the CPU."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import fabric_cuda as fc
    from repro_torch.core import fabric_torch as ft
    from repro_torch.core import simulator as sim
    from repro_torch.core.fabric import Fabric
    from repro_torch.core.state import fabric_state
    from repro_torch.experiments import SPECS, compare_to_baseline, run_spec
    from repro_torch.experiments import engine as exp_engine
    from repro_torch.kernels import build

    dev = torch.device(device_name)
    on_card = dev.type == "cuda"
    # f32 products in full f32 on the card (the tolerances assume it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    baseline = json.loads(BASELINE.read_text())
    xxl, xl = SPECS["weak_scaling_xxl"], SPECS["weak_scaling_xl"]

    def cold():
        exp_engine._CACHE.clear()
        sim.clear_merge_memo()

    # 1. the card and the build -----------------------------------------
    if on_card:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(f"card: {smi}")
        t0 = time.perf_counter()
        paths = build.build()
        print(f"build: {', '.join(p.name for p in paths.values())} in"
              f" {time.perf_counter() - t0:.3f} s")
        for name in paths:
            log = build.log_path(name).read_text()
            regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
            spills = sum(int(n) for n in
                         re.findall(r"(\d+) bytes spill stores", log))
            print(f"ptxas {name}: {len(regs)} kernels, registers {regs},"
                  f" spill stores {spills} bytes")
        _flash_build_report(build, paths["flash_attention"])

    # 2. kernel vs plain version ----------------------------------------
    part_xxl = _smoke_point(xxl, "part")
    items, fins = _grid([part_xxl])
    random_item, random_fin = _random_ragged_grid(dev)
    per_rank = np.bincount(random_item.src, minlength=random_item.n_ranks)
    sent = per_rank[per_rank > 0]
    heavy = float(sent.max() / sent.mean())
    check(heavy > 20 and len(np.unique(sent)) > 100,
          f"random grid: rank-records not ragged and heavy-ranked"
          f" (max/mean {heavy:.1f}, {len(np.unique(sent))} depths)")
    errs = []
    cases = (("xxl-finish", items, fins), ("xxl-arrivals", items, None),
             ("random-finish", [random_item], [random_fin]),
             ("random-arrivals", [random_item], None))
    for name, its, fs in cases:
        ops, _ = fc.grid_ops(its, fs, dev)
        got, ref = fc.fabric_scan(ops), fc.fabric_scan_ref(ops)
        if on_card:
            torch.cuda.synchronize()
        check(_outputs_equal(got, ref),
              f"{name}: kernel differs from fabric_scan_ref")
        errs.append(_max_abs_err(got, ref))
    print(f"kernel vs plain: {len(cases)} cases bitwise equal"
          f" (n={len(items[0])} XXL messages, {len(random_item)} random:"
          f" {len(sent)} rank-records of {sent.min()} to {sent.max()}"
          f" messages, max/mean {heavy:.1f}), max_abs_err={max(errs)!r}")

    # 3. the main path: XXL smoke tier on engine cuda -------------------
    cold()
    batches = []
    real_scan = fc.fabric_scan

    def counted(ops):
        batches.append(ops.n)
        return real_scan(ops)
    fc.fabric_scan = counted
    fc.LAUNCHES["fabric_scan"] = 0
    try:
        t0 = time.perf_counter()
        res_xxl = run_spec(xxl, "smoke", engine="cuda", device=dev)
        wall_xxl = time.perf_counter() - t0
    finally:
        fc.fabric_scan = real_scan
    launches = fc.LAUNCHES["fabric_scan"]
    check(launches > 0 or not on_card,
          "main path did not launch fabric_scan")
    check(launches == len(batches) or not on_card,
          f"fabric_scan: {launches} launches for {len(batches)}"
          f" super-batches")
    v = compare_to_baseline(baseline, {xxl.name: res_xxl})
    check(not v, "weak_scaling_xxl baseline drift: " + "; ".join(v))
    for key, m in res_xxl.items():
        ref_m = baseline["specs"][xxl.name]["records"][key]
        check(m["n_messages"] == ref_m["n_messages"],
              f"{key}: n_messages {m['n_messages']} != {ref_m['n_messages']}")
        check(all(np.isfinite(x) for x in m.values()), f"{key}: not finite")
    print(f"main path weak_scaling_xxl smoke (cuda): {len(res_xxl)} records,"
          f" 0 baseline violations, n_messages exact, fabric_scan launches"
          f" {launches} over {len(batches)} super-batches of {batches}"
          f" messages ({launches / max(1, len(batches)):g} per"
          f" super-batch), wall {wall_xxl:.3f} s")

    # 4. engine agreement on the XL smoke tier --------------------------
    recs = {}
    for engine in ("torch", "cuda"):
        cold()
        recs[engine] = run_spec(xl, "smoke", engine=engine, device=dev)
        v = compare_to_baseline(baseline, {xl.name: recs[engine]})
        check(not v, f"weak_scaling_xl on {engine}: " + "; ".join(v))
    check(recs["torch"] == recs["cuda"],
          "weak_scaling_xl: torch and cuda records differ")
    print(f"engine agreement weak_scaling_xl smoke: {len(recs['cuda'])}"
          f" records bitwise equal on torch and cuda, 0 baseline violations")

    # 5. the warm path ---------------------------------------------------
    kw = dict(dims=(8, 8, 8), theta=4, n_threads=2, n_vcis=2,
              local_shape=(64, 64, 64))
    before = fc.LAUNCHES["fabric_scan"]
    rc = sim.simulate_stencil("part", engine="cuda", device=dev, **kw)
    rv = sim.simulate_stencil("part", engine="vector", device=dev, **kw)
    check(fc.LAUNCHES["fabric_scan"] > before or not on_card,
          "warm path took the scalar fallback")
    check(rc.rank_tts_s == rv.rank_tts_s and rc.tts_s == rv.tts_s
          and rc.sent_per_rank == rv.sent_per_rank,
          "warm path differs from engine vector")
    (item8,), _ = _grid([dict(approach="part", **kw)])
    cols = (item8.t_ready, item8.nbytes, item8.vci, item8.thread, item8.put,
            item8.am_copy, item8.src, item8.dst)
    fv = Fabric(item8.cfg, item8.n_vcis, n_ranks=item8.n_ranks)
    fcu = fc.CudaFabric(item8.cfg, item8.n_vcis, n_ranks=item8.n_ranks,
                        device=dev)
    for _ in range(2):  # the second batch starts from warm state
        check(np.array_equal(fv.transmit_arrays(*cols),
                             fcu.transmit_arrays(*cols)),
              "warm batch arrivals differ from engine vector")
    sv, sc = fabric_state(fv), fabric_state(fcu)
    check(all(np.array_equal(sv[k], sc[k]) if isinstance(sv[k], np.ndarray)
              else sv[k] == sc[k] for k in sv),
          "warm state differs from engine vector")
    print(f"warm path: simulate_stencil part 8x8x8 on cuda equals vector"
          f" ({len(rc.rank_tts_s)} ranks); two warm batches and carried"
          f" state exact")

    # 6. times at the XXL shapes ----------------------------------------
    pts = [_smoke_point(xxl, ap) for ap in ("pt2pt_single", "part")]
    items, fins = _grid(pts)
    ops, _ = fc.grid_ops(items, fins, dev)
    reps = 20 if on_card else 3
    ms = _timed(lambda: fc.fabric_scan(ops), dev, reps)
    enqueue_ms = _host_ms(lambda: fc.fabric_scan(ops), dev, reps)
    prof_ms, prof_events = None, None
    if on_card:  # ten calls in one traced window: device time a call
        _, busy, n_ev, _ = _device_split(
            lambda: [fc.fabric_scan(ops) for _ in range(10)], dev)
        prof_ms, prof_events = busy / 10, n_ev / 10
    plain_ms = _timed(lambda: fc.fabric_scan_ref(ops), dev, max(3, reps // 4))
    t_ops = ft._bucket_operands(items, dev)
    torch_ms = _timed(lambda: ft._pipeline(t_ops), dev, max(3, reps // 4))
    old_bytes, nbytes = _legacy_bytes(ops, fins), _scan_bytes(ops)
    nops = _scan_ops(ops)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, nops / FP64_OPS_PER_S) * 1e3
    old_bound_ms = old_bytes / HBM_BYTES_PER_S * 1e3
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                >= nops / FP64_OPS_PER_S else "operations")
    per_batch = fc.LAUNCHES["fabric_scan"]
    fc.fabric_scan(ops)
    per_batch = fc.LAUNCHES["fabric_scan"] - per_batch
    print(f"times XXL super-batch ({ops.n} messages, {ops.sizes[1]}"
          f" rank-records, {per_batch} launch): fabric_scan event window"
          f" {ms:.4f} ms, host enqueue {enqueue_ms:.4f} ms, profiler"
          f" device time {prof_ms} ms a call ({prof_events} device events"
          f" a call); bound {bound_ms:.4f} ms ({nbytes} bytes, {nops}"
          f" fp64 ops), share {bound_ms / ms:.3f} of the event window and"
          f" {bound_ms / prof_ms if prof_ms else float('nan'):.3f} of the"
          f" device time; the stage-bucketed layout counted"
          f" {old_bytes} bytes, {old_bound_ms:.4f} ms (for continuity);"
          f" fabric_scan_ref {plain_ms:.4f} ms,"
          f" torch engine pipeline {torch_ms:.4f} ms")
    r_ops, _ = fc.grid_ops([random_item], [random_fin], dev)
    r_ms = _timed(lambda: fc.fabric_scan(r_ops), dev, reps)
    print(f"times random grid ({r_ops.n} messages, {r_ops.sizes[1]}"
          f" rank-records, the deepest {sent.max()}): fabric_scan"
          f" {r_ms:.4f} ms (finish), bound"
          f" {_scan_bytes(r_ops) / HBM_BYTES_PER_S * 1e3:.4f} ms in bytes")
    cold()
    t0 = time.perf_counter()
    sim._grid_entries(pts)
    t_prep = time.perf_counter() - t0
    t0 = time.perf_counter()
    items, fins = _grid(pts)
    fc.grid_ops(items, fins, dev)
    t_asm = time.perf_counter() - t0
    cold()
    t0 = time.perf_counter()
    run_spec(xxl, "smoke", engine="cuda", device=dev)
    wall = time.perf_counter() - t0
    print(f"wall XXL smoke tier (cuda, cold): {wall:.3f} s; host point"
          f" assembly {t_prep:.3f} s, super-batch assembly and upload"
          f" {t_asm - t_prep:.3f} s")
    fabric = {
        "name": "fabric_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/fabric_scan.cu",
        "replaces": "src/repro/core/fabric_pallas.py:434",
        "launches": launches, "max_abs_err": max(errs), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}

    # 7-9. the serving path and its flash kernel -------------------------
    flash_errs = flash_phase(dev, small)
    serving = serving_phase(dev, small)
    flash = serving_times(dev, serving, flash_errs, small)
    del serving
    if on_card:
        torch.cuda.empty_cache()

    # 10-14. the training path and its pack and quant8 kernels ------------
    if on_card:  # 10. built with the others in phase 1: bind them
        from repro_torch.kernels import bucket_pack as bp
        from repro_torch.kernels import quant8 as q8
        bp._library()
        q8._library()
        print("bucket_pack and quant8 kernels built (phase 1) and bound")
    errs = {"pack": pack_phase(dev, small), "quant": quant_phase(dev, small)}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if on_card else "gloo", rank=0, world_size=1,
            store=dist.FileStore(os.path.join(tmp, "store"), 1))
        try:
            train = training_phase(dev, small)
            train_kernels = train_times(dev, train, errs, small)
        finally:
            dist.destroy_process_group()

    # 15. the paper's scenarios -------------------------------------------
    t0 = time.perf_counter()
    scenarios_phase(dev, baseline)
    print(f"phase 15 wall {time.perf_counter() - t0:.3f} s")
    return {"kernels": [fabric, *flash, *train_kernels]}


def fabric_times(tree: Path) -> dict:
    """The fabric kernel of the source tree ``tree`` on the card: median
    event-window ms of one super-batch, finish and arrivals mode, at the
    XXL shapes and on the random ragged grid of phase 2, the finish
    mode's host enqueue time and launches per super-batch, and the
    median of three cold XXL super-batch assemblies and uploads (phase
    6's figure).  Uses only what every version of the port's fabric
    engine offers (``grid_ops``, ``fabric_scan``, ``LAUNCHES``)."""
    import torch
    from repro_torch.core import fabric_cuda as fc
    from repro_torch.core import simulator as sim
    from repro_torch.experiments import SPECS
    dev = torch.device("cuda")
    pts = [_smoke_point(SPECS["weak_scaling_xxl"], ap)
           for ap in ("pt2pt_single", "part")]
    asm = []
    for _ in range(3):  # phase 6's super-batch assembly and upload, cold
        sim.clear_merge_memo()
        sim._grid_entries(pts)
        t0 = time.perf_counter()
        items, fins = _grid(pts)
        fc.grid_ops(items, fins, dev)
        torch.cuda.synchronize()
        asm.append(time.perf_counter() - t0)
    random_item, random_fin = _random_ragged_grid(dev)
    out = {"tree": str(tree), "card": torch.cuda.get_device_name(0),
           "assembly_s": sorted(asm)[1]}
    for name, its, fs in (("xxl", items, fins),
                          ("random", [random_item], [random_fin])):
        ops, _ = fc.grid_ops(its, fs, dev)
        before = fc.LAUNCHES["fabric_scan"]
        fc.fabric_scan(ops)
        launches = fc.LAUNCHES["fabric_scan"] - before
        arr_ops, _ = fc.grid_ops(its, None, dev)
        out[name] = {"n": sum(len(i) for i in its), "launches": launches,
                     "ms": _timed(lambda: fc.fabric_scan(ops), dev, 20),
                     "enqueue_ms": _host_ms(lambda: fc.fabric_scan(ops),
                                            dev, 20),
                     "arrivals_ms": _timed(lambda: fc.fabric_scan(arr_ops),
                                           dev, 20)}
    return out


def _nonfinite_probe(dev):
    """Two seeded blocks, a NaN in the first and ``+inf`` in the second:
    what JAX gives is scales [nan, inf] and every int8 value 0."""
    import torch
    x = _seeded((512,), torch.float32, dev, 0)
    x[3] = float("nan")
    x[300] = float("inf")
    return x


def _quant_device(fn, kernel: str):
    """Device ms per call of ``fn`` over 10 calls (``_device_profile``),
    checked to trace exactly 10 kernels named ``kernel`` (the whole name
    after its namespace: ``quant_kernel`` is no ``dequant_kernel``) and no
    other device event, so no host-to-device copy."""
    ms, events, htod, names = _device_profile(fn, expect=10)
    check(events == 10 and htod == 0
          and all(re.search(rf"::{kernel}[<(]", k) for k, _ in names),
          f"10 calls traced {events} device events {names}, HtoD {htod};"
          f" want 10 {kernel} kernels")
    return ms


def quant8_times(tree: Path) -> dict:
    """The quant8 kernels of the source tree ``tree`` on the card, at 2^24
    f32 elements (and bf16 quantize): launches per call, the median
    event window, host enqueue and profiler device ms a call, and the
    non-finite probe's scales and int8 values at its NaN and ``inf``
    (with the dequantized value there).  Uses only what every version
    of the port offers (``kernels.ops``, ``quant8.LAUNCHES``)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant8 as q8
    dev = torch.device("cuda")
    n = 1 << 24
    x = _seeded((n,), torch.float32, dev, 3)
    xb = x.to(torch.bfloat16)
    q, s = ops.quantize_blockwise(x)
    out = {"tree": str(tree), "card": torch.cuda.get_device_name(0), "n": n}
    for name, what, fn in (
            ("quantize_blockwise", "quant", lambda: ops.quantize_blockwise(x)),
            ("quantize_blockwise_bf16", "quant",
             lambda: ops.quantize_blockwise(xb)),
            ("dequantize_blockwise", "dequant",
             lambda: ops.dequantize_blockwise(q, s))):
        key = name.replace("_bf16", "")
        before = q8.LAUNCHES[key]
        fn()
        rec = {"launches": q8.LAUNCHES[key] - before,
               "ms": _timed(fn, dev, 20), "enqueue_ms": _host_ms(fn, dev, 20)}
        ms, events, htod, names = _device_profile(fn)
        rec.update(device_ms=ms, events=events, htod=htod,
                   kernels=sorted({k for k, _ in names}))
        out[name] = rec
    p = _nonfinite_probe(dev)
    qp, sp = ops.quantize_blockwise(p)
    yp = ops.dequantize_blockwise(qp, sp)
    out["nonfinite"] = {
        "scales": [repr(float(v)) for v in sp],
        "q_at_nan": int(qp[3]), "q_at_inf": int(qp[300]),
        "y_at_nan": repr(float(yp[3])), "y_at_inf": repr(float(yp[300])),
        "nonzero_q": [int((qp[:256] != 0).sum()), int((qp[256:] != 0).sum())]}
    return out


def _card_ready() -> bool:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return False
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is"
              " False)", file=sys.stderr)
        return False
    return True


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not _card_ready():
        return 1
    import torch
    tree = ROOT
    times = {"--fabric-times": fabric_times, "--quant8-times": quant8_times}
    if argv[:1] and argv[0] in times and len(argv) <= 2:
        tree = Path(argv[1]).resolve() if len(argv) > 1 else ROOT
    elif argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 1
    if not (tree / "src" / "repro_torch").is_dir() or not BASELINE.exists():
        print("chip_smoke: run from a checkout of the repository"
              " (src/repro_torch and BENCH_scenarios.json)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(tree / "src"))
    if argv:
        try:
            print(json.dumps(times[argv[0]](tree)))
        except Exception:
            traceback.print_exc()
            return 1
        return 0
    try:
        table = run("cuda")
    except Exception:  # report the failing phase, then fail the run
        traceback.print_exc()
        return 1
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
