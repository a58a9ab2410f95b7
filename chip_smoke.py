#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` and
drives the port's two paths on the card -- the stencil simulator and
model serving -- phase by phase; every phase prints one line and any
failure exits non-zero without a result:

  1. the card (``nvidia-smi`` name and power limit) and the build of
     both kernels, one ``nvcc`` each, started together;
  2. the fused fabric kernel against its plain PyTorch version
     (``fabric_scan_ref``) on the card, bitwise, in finish and arrivals
     mode at the 32768-rank ``weak_scaling_xxl`` shapes and on a random
     grid whose stages need masked buckets;
  3. the main path: the ``weak_scaling_xxl`` smoke tier on engine
     ``cuda``, held against the golden ``BENCH_scenarios.json``, with
     the kernel's launch count over that run;
  4. engine agreement: the ``weak_scaling_xl`` smoke tier on engines
     ``torch`` and ``cuda``, bitwise equal and both on the baseline;
  5. the warm path: a 512-rank stencil through ``CudaFabric`` with the
     normal adaptive routing, and a second warm batch, exact against the
     NumPy engine;
  6. times at the XXL shapes: the kernel's per super-batch, the plain
     version's, the torch engine's, and the XXL smoke tier's wall time
     with its host assembly;
  7. the flash-attention kernel against its plain version
     (``flash_attention_plain``) on the card, f32 and bf16, at the
     llama3.2-1b prefill shape, a gemma2 shape where the window bites,
     ragged, decode-like, and head dims 16 and 128;
  8. the serving path: llama3.2-1b at full width (random weights from
     seed 0), the prefill/decode check in f32, then 4 prompts of 1024
     tokens prefilled in bf16 into a 1056-position cache and 32 tokens
     decoded greedily, with the flash kernel's launch count over that
     run and the prefill's logits against the same prefill through
     ``masked_attention``;
  9. times at the llama prefill shape: the flash kernel, its plain
     version and ``scaled_dot_product_attention`` (a yardstick only,
     never on the port's path), the batch's prefill and decode per
     token; then the kernel table as one JSON line.

The last line is ``{"ok": true, "device": {...}}``.  The script imports
nothing of the JAX package; it reads the baseline as data.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
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

# Flash kernel vs its plain version: the reference's own tolerances
# (tests/test_kernels.py), as rtol = atol.
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# Prefill logits through the flash kernel vs through masked_attention,
# both bf16, max |dlogit|.  The two softmaxes round differently (the
# kernel keeps P.V in f32, the model path casts probabilities to bf16
# first) and the difference passes through 16 bf16 layers; the logits
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


def _random_masked_grid(device):
    """A random super-batch whose stage and finish groups span many
    distinct depths, so every stage is bucketed with masks."""
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
    """Bytes the super-batch must move at least: every input read once,
    the per-rank output written once."""
    seen = {}

    def add(t):
        if t is not None:
            seen[t.data_ptr()] = t.numel() * t.element_size()
    for t in (ops.t_ready, ops.c1, ops.c3, ops.rdv, *ops.init, ops.pos3,
              ops.fperm, ops.foff):
        add(t)
    for bks in ops.stages:
        for b in bks:
            add(b.ridx)
            add(b.cidx)
            add(b.mask)
    for b in (*ops.fin_flows, *ops.fin_ranks):
        add(b.idx)
        add(b.mask)
    out = ops.n_rank_out if ops.finish else ops.n + sum(
        a.numel() for a in ops.init)
    return sum(seen.values()) + 8 * out


def _scan_ops(ops) -> int:
    """Float64 operations of the super-batch: max and add per lane of
    stages 1 and 2, three adds more per wire lane (rendezvous, delivery
    tail), a max per reduced lane and one add per flow."""
    s1, s2, s3 = ops.sizes
    n = 2 * s1 + 2 * s2 + 5 * s3
    if ops.finish:
        n += sum(b.K * b.G for b in (*ops.fin_flows, *ops.fin_ranks))
        n += ops.fperm.numel()
    return n


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
    """Least time of one call: the larger of its tensor-core FLOPs
    (QK^T and PV, 2 * 2 * D per kept pair) at the bf16 peak and q, k, v
    and o read or written once at the HBM rate."""
    _, b, h, hkv, sq, sk, d, causal, window, _ = case
    flops = 4 * b * h * d * _attn_pairs(sq, sk, causal, window)
    nbytes = itemsize * d * (2 * b * h * sq + 2 * b * hkv * sk)
    t_ops, t_bytes = flops / BF16_TC_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def flash_phase(dev, small: bool = False) -> float:
    """Phase 7: the flash kernel against its plain version on every case
    in f32 and bf16.  Returns the largest |difference|."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    errs = []
    for case in FLASH_CASES_SMALL if small else FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _flash_inputs(case, dtype, dev)
            kw = _flash_kw(case)
            got = ops.flash_attention(q, k, v, **kw)
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
            errs.append(err)
            del q, k, v, got, want, g32, w32
    print(f"flash kernel vs plain: {len(errs)} cases (f32 within"
          f" {FLASH_TOL['float32']}, bf16 within {FLASH_TOL['bfloat16']}),"
          f" max_abs_err={max(errs)!r}")
    return max(errs)


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

    fa.LAUNCHES["flash_attention"] = 0
    out = serve.generate(cfg, scfg, model, prompts, gen)
    launches = fa.LAUNCHES["flash_attention"]
    check(launches == cfg.n_layers or dev.type != "cuda",
          f"serving path launched the flash kernel {launches} times, not"
          f" once per layer ({cfg.n_layers})")
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
          f" {launches}; flash vs masked_attention prefill max|dlogit|"
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
    """(wall ms, device-busy ms, device events, top three by device
    time) of one call of ``fn``, from ``torch.profiler``; busy is the sum
    of the device time of every traced device event (kernels, copies,
    fills: one stream, so none overlap)."""
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
    top = sorted(evs, reverse=True)[:3]
    return wall, busy, sum(c for _, _, c in evs), top


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
        tops = ", ".join(f"{k[:40]} {t / n:.3f} ms" for t, k, _ in top)
        print(f"profile {name} (per call): wall {wall / n:.3f} ms, device"
              f" busy {busy / n:.3f} ms, idle share {1 - busy / wall:.3f},"
              f" {events / n:.1f} device events; top: {tops}")


def serving_times(dev, serving: dict, small: bool = False) -> dict:
    """Phase 9: times at the llama prefill shape and of the serving
    path.  Returns the flash kernel's table entry."""
    import torch
    import torch.nn.functional as F
    from repro_torch import serve
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    case = (FLASH_CASES_SMALL if small else FLASH_CASES)[0]
    q, k, v = _flash_inputs(case, torch.bfloat16, dev, seed=1)
    kw = _flash_kw(case)
    reps = 10 if dev.type == "cuda" else 3
    ms = _timed(lambda: ops.flash_attention(q, k, v, **kw), dev, reps)
    plain_ms = _timed(lambda: fa.flash_attention_plain(q, k, v, **kw), dev,
                      max(5, reps // 2))
    group = q.shape[1] // k.shape[1]
    try:
        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
        sdpa()
    except TypeError:  # a PyTorch without enable_gqa: expand outside
        ke = k.repeat_interleave(group, dim=1)
        ve = v.repeat_interleave(group, dim=1)

        def sdpa():
            return F.scaled_dot_product_attention(q, ke, ve, is_causal=True)
    lib_ms = _timed(sdpa, dev, reps)
    bound_ms, bound_by, flops, nbytes = _flash_bound(case, 2)
    runs = [serve.generate(serving["cfg"], serving["scfg"], serving["model"],
                           serving["prompts"], serving["gen"])
            for _ in range(3)]
    prefill_ms = sorted(r["prefill_ms"] for r in runs)[1]
    decode_ms = sorted(r["decode_ms_per_token"] for r in runs)[1]
    b, s = serving["prompts"].shape
    if dev.type == "cuda":
        _profile_serving(dev, serving)
    print(f"times llama prefill shape {case[1:7]} bf16 causal: flash kernel"
          f" {ms:.4f} ms, flash_attention_plain {plain_ms:.4f} ms,"
          f" scaled_dot_product_attention {lib_ms:.4f} ms, bound"
          f" {bound_ms:.4f} ms ({bound_by}: {flops} FLOPs, {nbytes} bytes);"
          f" serving {b}x{s} prefill {prefill_ms:.3f} ms, decode"
          f" {decode_ms:.3f} ms per token (median of 3, host clock)")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:124",
            "launches": serving["launches"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def run(device_name: str = "cuda", small: bool = False) -> dict:
    """All phases on ``device_name``; returns the kernel table.
    ``small`` cuts the serving phases to the llama smoke config and
    small flash cases, for a rehearsal on the CPU."""
    import numpy as np
    import torch
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

    # 2. kernel vs plain version ----------------------------------------
    part_xxl = _smoke_point(xxl, "part")
    items, fins = _grid([part_xxl])
    random_item, random_fin = _random_masked_grid(dev)
    errs = []
    cases = (("xxl-finish", items, fins), ("xxl-arrivals", items, None),
             ("masked-finish", [random_item], [random_fin]),
             ("masked-arrivals", [random_item], None))
    for name, its, fs in cases:
        ops, _ = fc.grid_ops(its, fs, dev)
        if name.startswith("masked"):
            masked = [b.mask is not None for bks in ops.stages for b in bks]
            masked += [b.mask is not None
                       for b in (*ops.fin_flows, *ops.fin_ranks)]
            check(sum(masked) >= 3, f"{name}: too few masked buckets")
        got, ref = fc.fabric_scan(ops), fc.fabric_scan_ref(ops)
        if on_card:
            torch.cuda.synchronize()
        check(_outputs_equal(got, ref),
              f"{name}: kernel differs from fabric_scan_ref")
        errs.append(_max_abs_err(got, ref))
    print(f"kernel vs plain: {len(cases)} cases bitwise equal"
          f" (n={len(items[0])} XXL messages, {len(random_item)} random"
          f" masked), max_abs_err={max(errs)!r}")

    # 3. the main path: XXL smoke tier on engine cuda -------------------
    cold()
    fc.LAUNCHES["fabric_scan"] = 0
    t0 = time.perf_counter()
    res_xxl = run_spec(xxl, "smoke", engine="cuda", device=dev)
    wall_xxl = time.perf_counter() - t0
    launches = fc.LAUNCHES["fabric_scan"]
    check(launches > 0 or not on_card,
          "main path did not launch fabric_scan")
    v = compare_to_baseline(baseline, {xxl.name: res_xxl})
    check(not v, "weak_scaling_xxl baseline drift: " + "; ".join(v))
    for key, m in res_xxl.items():
        ref_m = baseline["specs"][xxl.name]["records"][key]
        check(m["n_messages"] == ref_m["n_messages"],
              f"{key}: n_messages {m['n_messages']} != {ref_m['n_messages']}")
        check(all(np.isfinite(x) for x in m.values()), f"{key}: not finite")
    print(f"main path weak_scaling_xxl smoke (cuda): {len(res_xxl)} records,"
          f" 0 baseline violations, n_messages exact, fabric_scan launches"
          f" {launches}, wall {wall_xxl:.3f} s")

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
    plain_ms = _timed(lambda: fc.fabric_scan_ref(ops), dev, max(3, reps // 4))
    t_ops = ft._bucket_operands(items, dev)
    torch_ms = _timed(lambda: ft._pipeline(t_ops), dev, max(3, reps // 4))
    nbytes, nops = _scan_bytes(ops), _scan_ops(ops)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, nops / FP64_OPS_PER_S) * 1e3
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S >= nops / FP64_OPS_PER_S
                else "operations")
    per_batch = fc.LAUNCHES["fabric_scan"]
    fc.fabric_scan(ops)
    per_batch = fc.LAUNCHES["fabric_scan"] - per_batch
    print(f"times XXL super-batch ({ops.n} messages, {per_batch} launches):"
          f" fabric_scan {ms:.4f} ms (host enqueue {enqueue_ms:.4f} ms),"
          f" fabric_scan_ref {plain_ms:.4f} ms,"
          f" torch engine pipeline {torch_ms:.4f} ms, bound {bound_ms:.4f} ms"
          f" ({nbytes} bytes, {nops} fp64 ops)")
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
    flash_err = flash_phase(dev, small)
    serving = serving_phase(dev, small)
    flash = serving_times(dev, serving, small)
    flash["max_abs_err"] = flash_err
    return {"kernels": [fabric, flash]}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is"
              " False)", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir() or not BASELINE.exists():
        print("chip_smoke: run from a checkout of the repository"
              " (src/repro_torch and BENCH_scenarios.json)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
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
