#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` and
drives the port's paths on the card -- the stencil simulator, model
serving, training, the paper's scenarios, the planner, the serving of
the MLA, Mamba-2, MoE and hybrid families and the two stub frontends,
the training of all of them, and partitioned communication over
``torch.distributed`` (ring collectives, the int8 ring with error
feedback, partitioned-KV flash decode), tensor-parallel serving and
training, the card-free dry run held to real steps, and the
evaluation tooling (the sweep's throughput bench, worker pool and
profile, the benchmark harness and the chaos command line) -- phase by
phase; every phase prints one line and any failure exits non-zero
without a result:

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
     campaigns of ``cuda`` against ``reference`` with no violation;
 16. the planner and the CommPlan IR: the full grids of ``autotune`` and
     ``ir_passes`` (24 records) on engine ``cuda`` against the baseline,
     each with its wall time and the fabric kernel's launches, which
     must be 0 (the reference's routing: one flow is scalar on every
     engine, the IR's batches are narrow); the fault-free
     ``ir_passes`` records (the others run on the NumPy faulty fabric)
     with the adaptive cutoffs at 0, ``run_ir`` bitwise against engine
     ``reference`` with the launches a record printed; and one
     ``earlybird.auto_sync_config`` on llama3.2-1b at full width (its
     leaves sized on the ``meta`` device) against the planner's choice
     on the same payload;
 17. the MLA, Mamba-2, MoE and hybrid families and the two stub
     frontends on the serving path: for minicpm3-4b, mamba2-780m,
     granite-moe-3b-a800m, hymba-1.5b, moonshot-v1-16b-a3b (its depth
     cut to ``MOONSHOT_LAYERS``), qwen2-vl-7b (M-RoPE, 64 seeded patch
     embeddings) and musicgen-medium (seeded frame embeddings), the
     smoke config on the card against the CPU (f32 logits of a prefill
     and 3 decode steps within 2e-5; qwen2-vl with explicit grid
     positions whose rows differ), then at full width the f32
     prefill/decode check (MoE without capacity drops; qwen2-vl on
     text) and, in bf16, 4 prompts of 1024 tokens and 32 greedy decode
     steps with the flash launches of that run (one per layer for the
     GQA prefills: granite-moe, hymba, moonshot, qwen2-vl 28, musicgen
     48; none for MLA and Mamba), prefill and decode times, peak memory
     and the top device ops of one prefill and of 4 decode steps; then
     the flash kernel against its plain version and timed beside SDPA,
     with its bound, at those five prefill shapes;
 18. every family trained at full width in f32 (the seven of phase 17),
     4 x 1024 tokens a step, 1 MiB buckets, on a one-rank ``nccl``
     group: partitioned for 3 steps, bulk and per_leaf for 1, depth cut
     to ``TRAIN_FAMILY_LAYERS`` (24) and further where the reckoned step
     would leave less than a quarter of the card free (each cut
     printed); all-reduces a step against the
     plan's buckets plus the loss's, pack/unpack launches a step
     against the plan's multi-leaf buckets, the step-0 loss within
     [0.5, 1.5] ln V and equal across the modes, the smoke config
     trained on the CPU and on the card within the CPU tests'
     tolerances; step ms, tokens/s, peak memory, and the device idle
     share and pack/unpack device ms of one profiled step;
 19. partitioned communication on a one-rank ``nccl`` group (the card
     holds one device, and NCCL takes one rank a device; the multi-rank
     behaviour is the CPU tests' on gloo ranks): (a) every ring
     collective of ``core.chunked_collectives`` at 64 MiB of f32 and 1,
     2 and 4 channels equal to its input, the int8 ring equal to
     quantize -> dequantize and to the CPU's, both collective matmuls
     equal to ``x @ w``, and ``compress_with_feedback`` over 3 steps on
     an f32 and a bf16 leaf equal to the CPU's, all bitwise; (b)
     ``flash_decode_shard`` against ``flash_decode_ref`` at llama3.2-1b's
     decode shape over its 128k context (B 1, H 32, Kv 8, D 64, S
     131072, bf16: the last position, position 17, a window of 4096,
     and that window with a softcap of 50), with its time, the oracle's
     and the default ``masked_attention`` decode's beside the byte
     bound; (c) llama3.2-1b at full width in bf16, 4 prompts of 1024
     tokens and 32 decode steps through ``make_decode_step`` with
     ``flash_decode``, teacher-forced from the default decode: logits
     within 5 bf16 ulps of its, 48 all-reduces a step, decode ms a token
     with and without, and the idle share of 8 steps of each; and the
     gemma2-9b and hymba-1.5b (at 4 layers) smoke configs decoded the
     same way in f32 on the card and on a one-rank gloo group on the
     CPU, within 2e-5.  Every line of the phase carries the card's
     ``nvidia-smi`` name and power limit;
 20. the evaluation tooling: (a) the sweep's ``--bench-engine`` smoke
     cells (every spec but the orchestration-bound runners' on engines
     vector, torch and cuda, the 32768-rank XXL tier on torch and cuda
     only; best of 3 cold runs, with the kernel's launches a cell) and
     the torch-vs-vector and cuda-vs-torch speedups, gated 2x against
     the committed ``BENCH_engine_torch.json``; (b) ``run_specs`` over
     the full ``fig5_contention`` and ``halo1d`` grids on engine cuda
     with two spawned workers, bitwise the in-process run and on the
     baseline; (c) ``--profile`` of the XXL smoke tier: the cold and
     warm walls and the memo counters; (d) ``python -m
     repro_torch.benchmarks.run --fast`` on engine cuda, its 288 rows
     equal in value to engine reference's (and its scenario JSON); (e)
     ``python -m repro_torch.chaos`` with 8 campaigns on the card, no
     violation.  Every line carries the card's name and power limit;
 21. the float32 mode and the mesh layer: (a) with
     ``compat.x64_mode(False)``, the XXL smoke tier on engine cuda (the
     float32 path: its ``fabric_scan_f32`` launches), then the XXL smoke
     tier and the thirteen scenario grids (155 records) on engines torch
     and cuda and the batched drivers' smoke records with the cutoffs at
     0, every float32 kernel launch held bitwise against its plain
     version on the same operands, every record within 1e-4 of the
     float64 oracle's times (rates and ratios of two times within
     2e-4), the counters exact; a float64 pass after it bitwise equal to
     the one before; the float32 kernel's event and device ms at the
     XXL super-batch beside the float64 kernel's, with both bounds;
     (b) a (1, 1) ``DeviceMesh`` over the one-rank ``nccl`` group:
     llama3.2-1b at full width in f32, 3 ZeRO-1 steps bitwise equal
     (losses, parameters, moments) to 3 unsharded steps from the same
     seed and to phase 13's partitioned losses, and the decode cell of
     phase 19 (4 prompts of 1024 tokens, 32 steps through flash decode,
     bf16) with the cache placed by ``_cache_shardings``, its logits
     bitwise equal to the replicated-cache path's;
 22. the tensor- and expert-parallel serving forward: (a) a (1, 1) mesh
     over the one-rank ``nccl`` group, llama3.2-1b, granite-moe,
     mamba2, minicpm3 and hymba at full width in bf16 (depth cut by
     ``TP_LAYERS``), a 4 x 1024 prefill and 8 decode steps through the
     TP code path with the blocks of ``convert.tp_shard_model``, logits
     bitwise equal to the unsharded steps', flash launches a prefill =
     GQA layers; (b) two ``gloo`` ranks in processes of their own
     sharing the card (NCCL takes one rank a device), a (1, 2) mesh:
     llama3.2-1b and granite-moe at ``cfg.with_tp(2)``, greedy, flash
     decode off and on, every rank's logits within 5 bf16 ulps of the
     unsharded path's (granite's reference on the ranks' MoE routes),
     per-rank prefill and decode ms and their collectives' ms (gloo's,
     staged through the host), and the flash kernel at the rank-local
     shape against its plain version and SDPA;
 23. the tensor-parallel training step: (a) a (1, 1) mesh over the
     one-rank ``nccl`` group, llama3.2-1b at full width and depth in f32
     (3 steps), granite-moe and hymba at 8 layers (2 steps), 4 x 1024
     tokens, 1 MiB buckets: every step's loss and gradients and the
     final parameters bitwise the unsharded step's, pack and unpack
     launches a step the plan's on both paths, step ms of both; (b) two
     ``gloo`` ranks in processes of their own sharing the card, a (1, 2)
     mesh: llama3.2-1b at ``cfg.with_tp(2)``, 4 layers, 2 x 256 tokens,
     2 steps, every rank's losses and step-0 gradient blocks within the
     CPU tests' tolerance of the unsharded step on the card, step ms and
     the collectives' ms a rank;
 24. the dry run and the roofline rows: (a) in a subprocess whose
     default group is a fake group of 256 ranks, ``launch.dryrun`` on
     llama3.2-1b x train_4k and x decode_32k (rank 0 of the 16x16 mesh,
     fake ``cuda`` tensors, no allocation), each record's roofline terms
     and its ``roofline_report`` row printed; (b) the same subprocess
     traces phase 13's train cell (f32, 4 x 1024 tokens, 1 MiB buckets)
     and phase 9's prefill (bf16, B 4, S 1024) of llama3.2-1b at full
     depth on a (1, 1) mesh, while this process runs both steps for real
     over the one-rank ``nccl`` group (the flash and pack kernels on
     their path): ``FlopCounterMode``'s total and the ``compat.CALLS``
     counts and bytes by type equal to the dry run's exactly, the peak
     (``max_memory_allocated`` above what was allocated before the
     arguments) within ``DRYRUN_MEM_RTOL`` of the predicted peak, and
     each step's time over its roofline's largest term.  Then the
     kernel table as one JSON line, the float32 fabric kernel a row of
     its own.

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

    python3 chip_smoke.py --families [TREE]

runs phase 17 alone on the model code of ``TREE`` and prints, as one
JSON line, each family's prefill and decode ms and peak memory: the way
to hold two versions of the model code against each other in one call.

    python3 chip_smoke.py --train-families [TREE]

does the same for phase 18: each family's layers, step ms, tokens/s,
peak memory, idle share and pack/unpack device ms, and the depth cuts.

    python3 chip_smoke.py --tp

runs phase 22 alone (its kernels built first) and prints its numbers as
one JSON line.

    python3 chip_smoke.py --tp-train

runs phase 23 alone (its kernels built first) and prints its numbers
as one JSON line.

    python3 chip_smoke.py --dryrun

runs phase 24 alone (its kernels built first) over a one-rank ``nccl``
group and prints, as one JSON line, the build and phase seconds and
24b's measured FLOPs, collectives, argument and peak bytes and step ms.

    python3 chip_smoke.py --trace-attribution [TREE]

takes 60 profiler traces each of 10 pack and of 10 unpack calls at the
two buckets of phase 14 and prints, as one JSON line, how many measured
kernels each trace shows by their traced start time and by their launch,
and how far a kernel's traced start lies from its launch: the evidence
for the way phases 14 and 21 count a trace's kernels.
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


def _card_name() -> str:
    """``nvidia-smi``'s name and power limit of the card, printed beside
    the numbers ("cpu" in a rehearsal)."""
    import torch
    if not torch.cuda.is_available():
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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
    every input read once (three float columns of the operands' width w,
    the slot and output words, the finish offsets, the record
    descriptors and block starts, warm clocks), every output written
    once."""
    n, (g1, r, g3) = ops.n, ops.sizes
    w = ops.t_ready.element_size()
    inputs = (3 * w + 8) * n + 4 * ops.desc.numel() + 4 * ops.cta.numel()
    if ops.init is not None:
        inputs += w * (g1 + r + g3)
    if ops.finish:
        return inputs + w * n + w * ops.n_out
    return inputs + w * n + w * (g1 + r + g3)


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
    """Float operations of the super-batch: max and add in each of the
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


def _sync_groups(model, mode: str, aggr: int) -> list:
    """The leaf groups of one step's sync in ``mode``, each with the
    aggregation its plan is made with: partitioned syncs the leaves
    outside the layers and each layer's leaves on their own (``aggr``),
    bulk all leaves in 256 MiB buckets, per_leaf each leaf alone."""
    from repro_torch.models import lm
    leaves = lm.param_leaves(model.named_parameters())
    if mode == "partitioned":
        rest = [lf for lf in leaves if not lf[0].startswith("layers.")]
        return [(rest, aggr)] + [(lm.param_leaves(lp.named_parameters()),
                                  aggr) for lp in model.layers]
    return [(leaves, 256 << 20 if mode == "bulk" else 0)]


def _plans(model, mode: str, aggr: int) -> list:
    """(leaves, bucket plan) of each group of :func:`_sync_groups`."""
    from repro_torch.core import bucketing
    return [(leaves, bucketing.make_plan([s for _, s in leaves], a))
            for leaves, a in _sync_groups(model, mode, aggr) if leaves]


def _expected_packs(model, mode: str, aggr: int) -> int:
    """Multi-leaf buckets of one step's sync: the pack (and unpack)
    launches the plan asks for."""
    return sum(len(b.leaf_ids) > 1 for _, plan in _plans(model, mode, aggr)
               for b in plan.buckets)


def _expected_all_reduces(model, mode: str, aggr: int) -> int:
    """All-reduces of one step's sync: one per bucket of the plan, as the
    JAX package issues them (a stacked leaf is one), plus the loss's."""
    return 1 + sum(plan.n_buckets for _, plan in _plans(model, mode, aggr))


def _pack_vs_plain(model, mode: str, aggr: int, what: str) -> dict:
    """The pack and unpack kernels against their plain versions, bitwise,
    on ``model``'s gradients in every bucket that ``mode``'s sync packs
    (the plan's multi-leaf buckets), and the unpacked pieces against the
    gradients they were packed from.  The launch counts are restored
    after: these comparisons are not the path's launches."""
    from repro_torch.kernels import bucket_pack as bp
    saved = dict(bp.LAUNCHES)
    n, nbytes = 0, 0
    for leaves, plan in _plans(model, mode, aggr):
        for b in plan.buckets:
            if len(b.leaf_ids) < 2:
                continue
            segs = [p.grad for i in b.leaf_ids for p in leaves[i][1]]
            flat, ref = bp.bucket_pack(segs), bp.bucket_pack_plain(segs)
            check(_same_bits(flat, ref), f"{what}: the pack kernel and its"
                  f" plain version differ on bucket {n} ({len(segs)}"
                  f" segments, {flat.numel()} elements)")
            got = bp.bucket_unpack(flat, segs)
            want = bp.bucket_unpack_plain(ref, segs)
            check(all(_same_bits(x, y) and _same_bits(x, s)
                      for x, y, s in zip(got, want, segs)),
                  f"{what}: the unpack kernel, its plain version and the"
                  f" packed gradients differ on bucket {n}")
            n += 1
            nbytes += flat.numel() * flat.element_size()
            del flat, ref, got, want
    bp.LAUNCHES.update(saved)
    return {"buckets": n, "bytes": nbytes}


def _step0_against_first(first: dict, recs: dict, mode: str, what: str,
                         *, tol: float = 1e-6, leaf_scale: bool = False):
    """An ``at_step0`` for :func:`_train_mode`: the first mode's step-0
    loss and synced gradients are kept in ``first``, the gradients in
    one flat host buffer (pinned when they lie on the card, so that the
    copies run at the link's rate); every later mode's must give the
    same loss and gradients within ``tol`` relative to each element, or
    with ``leaf_scale`` to the largest |gradient| of its leaf (for a
    backward whose sums run in an order that varies from run to run, as
    MoE dispatch's scatter-adds may, while a misplaced piece of a bucket
    is off by the leaf's scale).  Each leaf is copied back and compared
    on the gradients' device; each that differs is listed under
    ``recs[mode]["grad_diff"]`` with its relative difference."""
    import torch

    def rel(t, ref):
        scale = ref.abs().max() if leaf_scale else ref.abs()
        return float(((t - ref).abs() / scale.clamp_min(1e-30)).max())

    def at_step0(state, loss0):
        rec = recs.setdefault(mode, {"grad_diff": []})
        grads = [(n, p.grad) for n, p in state["params"].named_parameters()]
        dev = grads[0][1].device
        if not first:
            check(all(g.dtype == torch.float32 for _, g in grads),
                  f"{what}: step-0 gradients not all f32")
            buf = torch.empty(sum(g.numel() for _, g in grads),
                              pin_memory=dev.type == "cuda")
            views, off = {}, 0
            for n, g in grads:
                views[n] = buf[off:off + g.numel()].view(g.shape)
                views[n].copy_(g, non_blocking=True)
                off += g.numel()
            _sync(dev)
            first.update(loss=loss0, grads=views)
            return
        diff = []
        for n, g in grads:
            ref = first["grads"][n].to(dev, non_blocking=True)
            if not torch.equal(g, ref):
                diff.append((n, rel(g, ref)))
        rec["grad_diff"] = diff = sorted(diff, key=lambda nd: -nd[1])
        check(not diff or diff[0][1] <= tol,
              f"{what}: step-0 gradients differ from the first mode's"
              f" beyond {tol} relative"
              f"{' to their leaf' if leaf_scale else ''}: {diff[:3]}")
        check(loss0 == first["loss"], f"{what}: step-0 loss {loss0!r} !="
              f" the first mode's {first['loss']!r}")
    return at_step0


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _train_mode(cfg, mode: str, n_steps: int, batches, dev, *, seq: int,
                batch: int, total_steps: int, at_step0=None):
    """``n_steps`` training steps of ``cfg`` in sync ``mode`` from fresh
    weights (seed 0) on ``batches``, through ``make_train_step`` on the
    one-rank group, ``TRAIN_AGGR`` buckets.  Checks finite losses,
    all-reduces a step equal to the plan's buckets plus the loss's, and
    on the card pack/unpack launches a step equal to the plan's
    multi-leaf buckets; ``at_step0(state, loss)`` runs after step 0.
    Returns (state, step function, record)."""
    import numpy as np
    import torch
    from repro_torch.kernels import bucket_pack as bp
    from repro_torch.launch import steps
    on_card = dev.type == "cuda"
    scfg = steps.StepConfig(sync_mode=mode, aggr_bytes=TRAIN_AGGR,
                            param_dtype="float32", warmup_steps=1,
                            total_steps=total_steps)
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
                      bp.LAUNCHES["bucket_unpack"] - before["bucket_unpack"]))
        n_ar.append(step.log.count())
        if i == 0 and at_step0 is not None:
            at_step0(state, losses[0])
    what = f"train {cfg.name} {mode}"
    check(all(np.isfinite(losses)), f"{what}: non-finite loss {losses}")
    check(not on_card or all(p == (want, want) for p in packs),
          f"{what}: pack/unpack launches per step {packs}, the plan has"
          f" {want} multi-leaf buckets")
    check(all(c == want_ar for c in n_ar),
          f"{what}: all-reduces per step {n_ar}, the plan has"
          f" {want_ar - 1} buckets and the loss one")
    return state, step, {
        "losses": losses, "times_ms": times, "packs": packs,
        "plan_multi": want, "n_all_reduce": n_ar, "plan_all_reduce": want_ar,
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                     if on_card else None)}


def training_phase(dev, small: bool = False) -> dict:
    """Phase 13: the training path, llama3.2-1b at full width and depth in
    f32 (random weights from seed 0), 4 x 1024 tokens a step, through
    ``make_train_step`` on the one-rank group: partitioned for 6 steps,
    bulk and per_leaf for 2, each from the same weights and batches.
    Checks the step-0 loss band, finite losses, pack/unpack launches per
    step against the plan, and equal step-0 losses and synced gradients
    across the modes; then the smoke config trained 3 steps on the CPU
    and on the card.  Returns what phase 14 and the kernel table need."""
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
    first = {}  # partitioned's step-0 loss and synced gradients
    for k in bp.LAUNCHES:
        bp.LAUNCHES[k] = 0
    for k in bp.ROUTES:
        bp.ROUTES[k] = 0
    for k in q8.LAUNCHES:
        q8.LAUNCHES[k] = 0
    t_main = time.perf_counter()
    for mode, n_steps in TRAIN_MODES:
        at_step0 = _step0_against_first(first, out["modes"], mode,
                                        f"train {cfg.name} {mode}")
        state, step, m = _train_mode(cfg, mode, n_steps, batches, dev,
                                     seq=seq, batch=batch, total_steps=n_max,
                                     at_step0=at_step0)
        if not small:
            check(LOSS0_RANGE[0] <= m["losses"][0] <= LOSS0_RANGE[1],
                  f"{mode}: step-0 loss {m['losses'][0]!r} outside"
                  f" {LOSS0_RANGE}")
        rec = out["modes"].setdefault(mode, {"grad_diff": []})
        rec.update(m)
        if on_card:  # one more step, under the profiler
            rec["profile"] = _device_split(
                lambda: step(state, batches[n_steps]), dev)
        del state, step
        if on_card:
            torch.cuda.empty_cache()
    out["launches"] = {**bp.LAUNCHES, **q8.LAUNCHES}
    out["routes"] = dict(bp.ROUTES)
    out["main_s"] = time.perf_counter() - t_main
    first.clear()
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


def _cpu_vs_card(dev, arch: str = "llama3.2-1b") -> dict:
    """``arch``'s smoke config trained 3 steps from the same weights and
    batches on the CPU (its own gloo group) and on the card: losses
    within ``TRAIN_LOSS_RTOL``, step-0 synced gradients within
    ``TRAIN_GRAD_TOL``.  qwen2-vl runs 96 tokens (64 patches) with
    explicit grid positions."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    cfg = get_smoke_config(arch).replace(param_dtype="float32")
    scfg = steps.StepConfig(sync_mode="partitioned", aggr_bytes=1 << 12,
                            param_dtype="float32", warmup_steps=1,
                            total_steps=6)
    seq = 96 if cfg.frontend == "vision_stub" else 64
    stream = pipeline.for_model(cfg, seq, 4)
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
        step = steps.make_train_step(cfg, scfg, seq_len=seq, batch=4,
                                     group=group, device=d)
        losses, g0 = [], None
        for i in range(3):
            st, loss = step(st, _train_batch(cfg, stream, i, d))
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
    print(f"train {arch} smoke cpu vs card, 3 steps: losses card {lc} cpu"
          f" {lh} (max rel {lerr!r}, tol {TRAIN_LOSS_RTOL}); step-0"
          f" gradients max(|d| - {rtol}|g|) = {gerr!r} (tol {atol})")
    check(lerr <= TRAIN_LOSS_RTOL,
          f"{arch} smoke training: cpu and card losses differ")
    check(gerr <= atol, f"{arch} smoke training: cpu and card gradients"
          f" differ")
    return {"loss_rel": lerr, "grad_excess": gerr}


def _train_batch(cfg, stream, i: int, dev):
    """Batch ``i`` of the data stream on ``dev``; the vision stub's gets
    explicit M-RoPE grid positions over its 64 patches (the stream makes
    none, and the train step needs them)."""
    import torch
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    b = steps.batch_to_device(stream.batch(i), dev)
    if cfg.mrope_sections is not None:
        n, s = b["tokens"].shape
        b["positions"] = torch.from_numpy(
            pipeline.grid_positions(n, s, 1, 8, 8)).to(dev)
    return b


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
            print(f"profile pack/unpack {name} bucket, 10 calls each"
                  f" between 10 warm-up and 10 tail calls: device ms per"
                  f" call pack kernel {prof[0][0]!r}, unpack kernel"
                  f" {prof[1][0]!r}, torch.cat {prof[2][0]!r},"
                  f" torch._foreach_copy_ {prof[3][0]!r}; the kernels'"
                  f" device events"
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


TRACE_GROUPS = ("warm-up", "measured", "tail")


def _trace_groups(fn, n: int):
    """One plain ``torch.profiler`` trace of three groups of ``n`` calls of
    ``fn`` -- a warm-up, the measured calls in a ``record_function``
    range, a tail -- each group drained by a synchronise and 2 ms apart.
    Returns the trace's events, the measured range and the correlation
    ids of the runtime calls (``cudaLaunchKernel``, ``cudaMemsetAsync``,
    ...) that start inside it: a device event shares its id with the
    call that issued it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for group in TRACE_GROUPS:
            time.sleep(0.002)
            with record_function(group):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
    events = prof.events()
    span = next(e.time_range for e in events
                if e.name == "measured" and e.device_type != cuda)
    issued = {e.id for e in events
              if e.device_type != cuda and e.name.startswith("cu")
              and span.start <= e.time_range.start <= span.end}
    return events, span, issued


def _device_profile(fn, n: int = 10, expect=None):
    """Device ms per call, device events and host-to-device copies of
    ``n`` calls of ``fn`` under ``torch.profiler``.  Also the device
    events' names and counts.

    A device event of a ``_trace_groups`` trace counts when the runtime
    call that issued it starts inside the measured range.  The device
    events' own start times are no guide: on the H100 the trace places
    kernels up to milliseconds before or after their launch on the
    host's clock, so that a test by start time misses some or all of
    the measured kernels in a few traces in a hundred, while the trace
    holds every one of them (``python3 chip_smoke.py
    --trace-attribution``); durations come from the device's clock
    alone and are sound.  A trace can still lose a group's events, if
    rarely (one in 240 there, outside the measured range).  Where
    the caller knows how many device events the ``n`` calls make
    (``expect``), a trace holding another count is taken again, up to
    three traces, and the last one is returned (the caller checks its
    count)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):
        events, _, issued = _trace_groups(fn, n)
        evs = {}
        for e in events:
            if (e.device_type == cuda and e.name not in TRACE_GROUPS
                    and e.id in issued):
                c, t = evs.get(e.name, (0, 0.0))
                evs[e.name] = (c + 1, t + e.time_range.elapsed_us() / 1e3)
        if expect is None or sum(c for c, _ in evs.values()) == expect:
            break
    return (sum(t for _, t in evs.values()) / n,
            sum(c for c, _ in evs.values()),
            sum(c for k, (c, _) in evs.items() if "htod" in k.lower()),
            [(k[:60], c) for k, (c, _) in evs.items()])


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


class _ScanCounter:
    """While installed (a ``with`` block), counts the calls of the cuda
    engine's fabric kernel wrapper; ``launched`` is the kernel's own
    launch count on the card and the wrapper's calls on the CPU (where
    the wrapper runs the plain version), and ``reset`` zeroes both."""

    def __init__(self, on_card: bool):
        from repro_torch.core import fabric_cuda
        self.fc, self.on_card, self.calls = fabric_cuda, on_card, []

    def __enter__(self):
        real = self.real = self.fc.fabric_scan

        def counted(ops):
            self.calls.append(ops.n)
            return real(ops)
        self.fc.fabric_scan = counted
        return self

    def __exit__(self, *exc):
        self.fc.fabric_scan = self.real

    def reset(self) -> None:
        self.calls.clear()
        self.fc.LAUNCHES["fabric_scan"] = 0

    def launched(self) -> int:
        return self.fc.LAUNCHES["fabric_scan"] if self.on_card \
            else len(self.calls)


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
    from repro_torch.core import simulator as sim
    from repro_torch.experiments import (SPECS, compare_to_baseline,
                                         contention_crossover, run_spec)
    from repro_torch.experiments import chaos
    from repro_torch.experiments import engine as exp_engine

    out, results = {}, {}
    with _ScanCounter(dev.type == "cuda") as scans:
        # (a) full grids, cold, under the default cutoffs
        for name, want in SCENARIO_LAUNCHES.items():
            exp_engine._CACHE.clear()
            sim.clear_merge_memo()
            scans.reset()
            t0 = time.perf_counter()
            res = run_spec(SPECS[name], "full", engine="cuda", device=dev)
            wall = time.perf_counter() - t0
            n = scans.launched()
            check(n == len(scans.calls), f"{name}: {n} launches for"
                  f" {len(scans.calls)} kernel calls")
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
                        scans.reset()
                        exp_engine.RUNNERS[spec.runner](p, engine="cuda",
                                                        device=dev)
                        per_record.append(scans.launched())
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


# Phase 16: the planner's specs.  Under the default cutoffs neither
# reaches the fabric kernel (as the reference's routing reaches no
# Pallas kernel there); the forced pass runs ir_passes' fault-free
# records with the cutoffs at 0.
PLANNER_SPECS = {"autotune": 18, "ir_passes": 6}


def planner_phase(dev, baseline: dict) -> dict:
    """Phase 16: the planner and the CommPlan IR on the card.  (a) the
    full grids of ``autotune`` and ``ir_passes`` on engine cuda against
    the baseline, 0 fabric kernel launches over each; (b) the fault-free
    ``ir_passes`` records with the cutoffs at 0, ``run_ir`` on cuda
    bitwise against engine reference, at least one launch a record; (c)
    ``auto_sync_config`` on llama3.2-1b.  Returns walls and launches."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import earlybird, planner
    from repro_torch.core import fabric as fb
    from repro_torch.core import simulator as sim
    from repro_torch.core.bucketing import leaf_nbytes
    from repro_torch.experiments import SPECS, compare_to_baseline, run_spec
    from repro_torch.experiments import engine as exp_engine
    from repro_torch.models import lm

    out = {}
    with _ScanCounter(dev.type == "cuda") as scans:
        # (a) full grids, cold, under the default cutoffs
        for name, n_records in PLANNER_SPECS.items():
            exp_engine._CACHE.clear()
            sim.clear_merge_memo()
            scans.reset()
            t0 = time.perf_counter()
            res = run_spec(SPECS[name], "full", engine="cuda", device=dev)
            wall = time.perf_counter() - t0
            n = scans.launched()
            check(len(res) == n_records, f"{name}: {len(res)} records")
            check(n == len(scans.calls) == 0, f"{name}: {n} fabric_scan"
                  f" launches ({len(scans.calls)} calls), the reference's"
                  f" routing gives 0")
            v = compare_to_baseline(baseline, {name: res})
            check(not v, f"{name} baseline drift: " + "; ".join(v))
            recs = baseline["specs"][name]["records"]
            for key, m in res.items():
                check(m["n_messages"] == recs[key]["n_messages"],
                      f"{name}/{key}: n_messages {m['n_messages']}")
                check(all(np.isfinite(x) for x in m.values()),
                      f"{name}/{key}: not finite")
                if name == "ir_passes":
                    check(m["ir_us"] <= m["pointwise_us"],
                          f"{name}/{key}: the guard let ir_us regress")
            out[name] = {"records": len(res), "wall_s": wall, "launches": n}
            print(f"planner {name} full (cuda): {len(res)} records, 0"
                  f" baseline violations, n_messages exact, wall"
                  f" {wall:.3f} s, fabric_scan launches {n}")

        # (b) the fault-free IR records with the cutoffs at 0
        spec = SPECS["ir_passes"]
        points = [p for p in spec.points("full") if p["scenario"] != "faults"]
        cutoffs = fb.SCALAR_BATCH_CUTOFF, fb.MIN_GROUP_PARALLELISM
        fb.SCALAR_BATCH_CUTOFF = fb.MIN_GROUP_PARALLELISM = 0
        per_record = []
        t0 = time.perf_counter()
        try:
            for p in points:
                scans.reset()
                got = exp_engine.run_ir(p, engine="cuda", device=dev)
                per_record.append(scans.launched())
                check(per_record[-1] == len(scans.calls), f"forced"
                      f" ir_passes: {per_record[-1]} launches for"
                      f" {len(scans.calls)} calls")
                want = exp_engine.run_ir(p, engine="reference", device=dev)
                check(got == want, f"forced ir_passes/"
                      f"{exp_engine.record_key(p)}: cuda {got} differs from"
                      f" reference {want}")
        finally:
            fb.SCALAR_BATCH_CUTOFF, fb.MIN_GROUP_PARALLELISM = cutoffs
        wall = time.perf_counter() - t0
        check(min(per_record) >= 1, f"forced ir_passes: launches a record"
              f" {per_record}")
        out["ir_passes"]["forced_launches"] = per_record
        print(f"planner ir_passes fault-free, cutoffs 0 (cuda vs"
              f" reference): {len(points)} records bitwise on every metric,"
              f" fabric_scan launches a record {per_record}, wall"
              f" {wall:.3f} s")

    # (c) the model-chosen sync config of llama3.2-1b
    t0 = time.perf_counter()
    model = lm.LM(get_config("llama3.2-1b"), device="meta")
    sync = earlybird.auto_sync_config(model)
    wall = time.perf_counter() - t0
    total = float(sum(leaf_nbytes(p) for p in model.parameters()))
    choice = planner.choose_plan(planner.gradient_desc(total))
    mode = {"pt2pt_single": "bulk", "pt2pt_many": "per_leaf",
            "part": "partitioned"}[choice.approach]
    check((sync.mode, sync.n_channels) == (mode, choice.n_vcis),
          f"auto_sync_config {sync} against the planner's {choice}")
    out["auto_sync"] = {"mode": sync.mode, "aggr_bytes": sync.aggr_bytes,
                        "n_channels": sync.n_channels, "wall_s": wall}
    print(f"auto_sync_config llama3.2-1b ({total:.0f} gradient bytes):"
          f" mode {sync.mode}, aggr_bytes {sync.aggr_bytes}, n_channels"
          f" {sync.n_channels} (planner: {choice.approach} theta"
          f" {choice.theta}, predicted {choice.predicted_us:.2f} us),"
          f" wall {wall:.3f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 17: the MLA, Mamba-2, MoE and hybrid families and the two stub
# frontends on the serving path
# ---------------------------------------------------------------------------

# In the order they run; the flash kernel launches once per layer in a
# GQA prefill (granite-moe, hymba, moonshot, qwen2-vl, musicgen), never
# for MLA and Mamba.
FAMILY_ARCHS = ("minicpm3-4b", "mamba2-780m", "granite-moe-3b-a800m",
                "hymba-1.5b", "moonshot-v1-16b-a3b", "qwen2-vl-7b",
                "musicgen-medium")
# moonshot-v1-16b-a3b's 48 layers are 56 GB in bf16 and 112 GB in f32:
# it runs at full width with its depth cut to this.
MOONSHOT_LAYERS = 8
# The port on the card against the port on the CPU, smoke configs, f32
# logits of a prefill and 3 decode steps, as rtol = atol.
FAMILY_CARD_TOL = 2e-5
# The prefill shapes this phase gives the flash kernel, bf16 (name, B,
# H, Hkv, Sq, Sk, D, causal, window, softcap): granite-moe, moonshot,
# hymba (25 heads, window 1024 on all layers but 0, 16 and 31), qwen2-vl
# (a GQA group of 7 at D 128), musicgen (plain MHA at D 64).
FAMILY_FLASH_CASES = (
    ("granite-moe-prefill", 4, 24, 8, 1024, 1024, 64, True, 0, None),
    ("moonshot-prefill", 4, 16, 16, 1024, 1024, 128, True, 0, None),
    ("hymba-prefill-window", 4, 25, 5, 1024, 1024, 64, True, 1024, None),
    ("qwen2-vl-prefill", 4, 28, 4, 1024, 1024, 128, True, 0, None),
    ("musicgen-prefill", 4, 24, 24, 1024, 1024, 64, True, 0, None),
)
FAMILY_FLASH_CASES_SMALL = (
    ("granite-moe-prefill", 1, 6, 2, 96, 96, 64, True, 0, None),
    ("moonshot-prefill", 1, 4, 4, 96, 96, 128, True, 0, None),
    ("hymba-prefill-window", 1, 5, 1, 96, 96, 64, True, 32, None),
    ("qwen2-vl-prefill", 1, 7, 1, 96, 96, 128, True, 0, None),
    ("musicgen-prefill", 1, 4, 4, 96, 96, 64, True, 0, None),
)


def _family_config(arch: str, small: bool):
    from repro_torch.configs import get_config, get_smoke_config
    if small:
        return get_smoke_config(arch)
    cfg = get_config(arch)
    if arch == "moonshot-v1-16b-a3b":
        cfg = cfg.replace(n_layers=MOONSHOT_LAYERS)
    return cfg


def _family_card_vs_cpu(arch: str, dev) -> float:
    """The smoke config on ``dev`` against the same weights and prompts
    on the CPU: f32 logits of a prefill and 3 decode steps fed the CPU
    run's greedy tokens (musicgen: seeded frames; qwen2-vl: 64 patches
    over 96 tokens with explicit grid positions, whose rows differ).
    Returns the largest |difference|."""
    import copy
    import torch
    from repro_torch import serve
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import pipeline
    from repro_torch.models import lm
    cfg = get_smoke_config(arch)
    cpu = serve.build_model(cfg, 0, "cpu")
    s = 96 if cfg.frontend == "vision_stub" else 24
    prompts, extra = serve.serving_inputs(cfg, 2, s, 3, 1, "cpu")
    batch = lm.input_batch(cfg, prompts)
    if "patch_embeds" in extra:
        batch.update(patch_embeds=extra["patch_embeds"],
                     positions=torch.from_numpy(
                         pipeline.grid_positions(2, s, 1, 8, 8)))

    def run_on(d, model, fed):
        cache = lm.init_cache(cfg, 2, s + 4, device=d)
        logits, cache = lm.prefill(
            cfg, model, {k: v.to(d) for k, v in batch.items()}, cache=cache)
        out = [logits.cpu()[:, :cfg.vocab]]
        for i, t in enumerate(range(s, s + 3)):
            if len(fed) == i:
                fed.append(out[-1].argmax(-1))
            frame = extra.get("frames")
            logits, cache = lm.decode_step(
                cfg, model, cache, fed[i].to(d), t,
                embeds=None if frame is None else frame[:, i:i + 1].to(d))
            out.append(logits.cpu()[:, :cfg.vocab])
        return out
    fed = []
    want = run_on(torch.device("cpu"), cpu, fed)
    got = run_on(dev, copy.deepcopy(cpu).to(dev), fed)
    err = 0.0
    for a, b in zip(got, want):
        check(bool(((a - b).abs() <= FAMILY_CARD_TOL
                    + FAMILY_CARD_TOL * b.abs()).all()),
              f"{arch} smoke: logits on {dev} and on the CPU differ by"
              f" {float((a - b).abs().max())!r}")
        err = max(err, float((a - b).abs().max()))
    return err


def family_phase(dev, small: bool = False) -> dict:
    """Phase 17: each family card against CPU (smoke config), the f32
    prefill/decode check and the bf16 serving run at full width (the
    smoke config when ``small``), with the flash launches of that run,
    its times, peak memory and the profiles of one prefill and of 4
    decode steps; then the flash kernel against its plain version at the phase's prefill
    shapes.  Returns the flash cases' times."""
    import torch
    from repro_torch import serve
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import (StepConfig, make_cache,
                                          make_decode_step,
                                          make_prefill_step)
    from repro_torch.models import lm
    on_card = dev.type == "cuda"
    batch, prompt_len, gen = (4, 64, 8) if small else (4, 1024, 32)
    scfg = StepConfig()
    out = {}
    for arch in FAMILY_ARCHS:
        t0 = time.perf_counter()
        card_err = _family_card_vs_cpu(arch, dev)
        cfg = _family_config(arch, small)
        model = serve.build_model(cfg, 0, dev)  # f32
        taps = ("conv_x", "conv_B", "conv_C", "bq", "bk", "bv")
        n_matrix = sum(p.numel() for n, p in model.named_parameters()
                       if p.dim() >= 2 and n.rsplit(".", 1)[-1] not in taps)
        check(n_matrix == cfg.param_count(),
              f"{arch}: parameters {n_matrix} != param_count"
              f" {cfg.param_count()}")
        err_cd = serve.check_consistency(
            cfg, model, serve.make_prompts(cfg, 2, 64, 1, dev))
        check(err_cd < serve.CONSISTENCY_TOL,
              f"{arch}: prefill/decode mismatch {err_cd!r} (f32)")
        model = lm.cast(model, getattr(torch, scfg.param_dtype))
        if on_card:
            torch.cuda.empty_cache()
        prompts, extra = serve.serving_inputs(cfg, batch, prompt_len, gen,
                                              2, dev)
        serve.generate(cfg, scfg, model, prompts, 1, **extra)  # warm-up
        t_setup = time.perf_counter() - t0

        # the main path: counts at 0 just before, read just after
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for key in fa.LAUNCHES:
            fa.LAUNCHES[key] = 0
        runs = [serve.generate(cfg, scfg, model, prompts, gen, **extra)]
        launches = dict(fa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        gqa = cfg.mixer in ("attn", "hybrid") and cfg.mla is None
        want = cfg.n_layers if gqa and on_card else 0
        check(launches["flash_attention"] == want
              and launches["flash_attention_wgmma"] == want,
              f"{arch}: flash launches {launches} over one batch, want"
              f" {want} (wgmma)")
        logits, toks = runs[0]["prefill_logits"], runs[0]["tokens"]
        check(tuple(logits.shape) == (batch, cfg.vocab_padded)
              and bool(torch.isfinite(logits[:, :cfg.vocab]).all()),
              f"{arch}: prefill logits")
        check(tuple(toks.shape) == (batch, gen) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.vocab, f"{arch}: generated tokens")
        runs += [serve.generate(cfg, scfg, model, prompts, gen, **extra)
                 for _ in range(2)]
        prefill_ms = sorted(r["prefill_ms"] for r in runs)[1]
        decode_ms = sorted(r["decode_ms_per_token"] for r in runs)[1]
        print(f"family {arch}{' smoke' if small else ''}"
              f" ({cfg.n_layers} layers, d {cfg.d_model},"
              f" {cfg.param_count()} parameters): card vs CPU smoke logits"
              f" max|d| {card_err!r} (tol {FAMILY_CARD_TOL}); f32"
              f" prefill/decode max|d| {err_cd!r}"
              f" (< {serve.CONSISTENCY_TOL}"
              f"{', MoE without capacity drops' if cfg.moe else ''}); bf16"
              f" {batch}x{prompt_len} + {gen} decode steps: flash launches"
              f" {launches['flash_attention']} (wgmma"
              f" {launches['flash_attention_wgmma']}, want {want}); prefill"
              f" {prefill_ms:.3f} ms, decode {decode_ms:.3f} ms per token"
              f" (median of 3, host clock; runs"
              f" {[round(r['prefill_ms'], 3) for r in runs]},"
              f" {[round(r['decode_ms_per_token'], 3) for r in runs]}),"
              f" peak memory {peak / 2**30:.3f} GiB; setup {t_setup:.3f} s")
        if on_card:  # one prefill, then 4 decode steps on its cache
            max_len = prompt_len + 4
            prefill = make_prefill_step(cfg, scfg, seq_len=prompt_len,
                                        batch=batch, device=dev)
            decode = make_decode_step(cfg, scfg, seq_len=max_len,
                                      batch=batch, device=dev)
            cache = make_cache(cfg, scfg, batch=batch, max_len=max_len,
                               device=dev)
            audio = lm.input_key(cfg) == "embeds"
            pbatch = lm.input_batch(
                cfg, prompts,
                **{k: v for k, v in extra.items() if k != "frames"})
            tok, frame = ((None, extra["frames"][:, :1]) if audio
                          else (prompts[:, -1], None))

            def steps4():
                for t in range(prompt_len, max_len):
                    decode(model, cache, tok, t, embeds=frame)
            for name, fn, n in (
                    ("prefill", lambda: prefill(model, pbatch, cache), 1),
                    ("decode", steps4, 4)):
                wall, busy, events, top = _device_split(fn, dev)
                tops = "; ".join(f"{k[:48]} {t / n:.3f} ms x{c / n:g}"
                                 for t, k, c in top[:5])
                print(f"profile {arch} {name} (per call): wall"
                      f" {wall / n:.3f} ms, device busy {busy / n:.3f} ms,"
                      f" idle share {1 - busy / wall:.3f}, {events / n:g}"
                      f" device events; top: {tops}")
        out[arch] = {"prefill_ms": prefill_ms, "decode_ms": decode_ms,
                     "peak_bytes": peak, "launches": launches}
        del model, prompts, extra, runs, logits
        if on_card:
            torch.cuda.empty_cache()

    cases = FAMILY_FLASH_CASES_SMALL if small else FAMILY_FLASH_CASES
    reps = 10 if on_card else 3
    for case in cases:
        q, k, v = _flash_inputs(case, torch.bfloat16, dev)
        kw = _flash_kw(case)
        before = fa.LAUNCHES["flash_attention_wgmma"]
        got = ops.flash_attention(q, k, v, **kw)
        check(fa.LAUNCHES["flash_attention_wgmma"] == before + 1
              or not on_card, f"flash {case[0]}: wgmma did not launch")
        want = fa.flash_attention_plain(q, k, v, **kw)
        tol = FLASH_TOL["bfloat16"]
        g32, w32 = got.float(), want.float()
        err = float((g32 - w32).abs().max())
        check(bool(((g32 - w32).abs() <= tol + tol * w32.abs()).all()),
              f"flash {case[0]}: max|diff| {err!r} beyond {tol}")
        print(f"flash {case[0]} {tuple(case[1:7])} bf16 vs plain:"
              f" max_abs_err {err!r} (within {tol})")
        out[case[0]] = _flash_times(case, torch.bfloat16, dev, reps)
        del q, k, v, got, want, g32, w32
    return out


# ---------------------------------------------------------------------------
# Phase 18: training of every family at full width
# ---------------------------------------------------------------------------

# The families and stub frontends (llama3.2-1b is phase 13), in the
# order they run, and the modes with their steps.
TRAIN_FAMILY_ARCHS = FAMILY_ARCHS
TRAIN_FAMILY_MODES = (("partitioned", 3), ("bulk", 1), ("per_leaf", 1))
# Step-0 synced gradients of the three modes, relative to the largest
# |gradient| of each leaf: the MoE backward's scatter-adds sum in a
# varying order (run to run 5.4e-7 on moonshot's smoke config on the
# CPU); a misplaced or corrupted piece of a bucket is off by about 1.
TRAIN_FAMILY_GRAD_TOL = 1e-5
# The share of the card's memory a step may reckon to use.
TRAIN_MEM_SHARE = 0.75
# The most layers a family trains at, to keep the whole script within
# two thirds of its time limit (the memory rule cuts deeper where it
# must).
TRAIN_FAMILY_LAYERS = 24


def _train_bytes(cfg, batch: int, seq: int) -> float:
    """Reckoned peak device bytes of an f32 training step: 16 B a
    parameter (weights, gradients, two AdamW moments), the layer inputs
    that remat keeps, and the largest transient of three: the CE
    chunk's logits with their softmax and gradient, the f32 temporaries
    of AdamW's update of the largest leaf (up to seven live at once in
    ``optim.adamw.adamw_update``), and one layer recomputed in
    backward (12 f32 activations of its widest hidden per token, and
    the attention scores of a query chunk three times over)."""
    tokens, d = batch * seq, cfg.d_model
    largest = cfg.vocab_padded * d
    width = max(cfg.d_ff, d)
    if cfg.moe is not None:
        mo = cfg.moe
        largest = max(largest, mo.e_pad * d * mo.d_expert)
        width = max(width, int(mo.capacity_factor * mo.top_k
                               * mo.d_expert) + mo.e_pad)
    if cfg.mamba is not None:
        width = max(width, 3 * cfg.mamba.d_inner(d))
    scores = 3 * batch * cfg.n_heads_padded * min(cfg.q_chunk, seq) * seq
    ws = max(3 * batch * min(cfg.loss_chunk, seq) * cfg.vocab_padded,
             7 * largest, 12 * tokens * width + scores)
    return 4 * (4 * cfg.param_count(padded=True) + cfg.n_layers * tokens * d
                + ws)


def train_depth(cfg, batch: int, seq: int, total: int) -> int:
    """The most layers, up to the config's, whose reckoned step
    (:func:`_train_bytes`) keeps a quarter of ``total`` bytes free."""
    n = cfg.n_layers
    while n > 1 and _train_bytes(cfg.replace(n_layers=n), batch, seq) \
            > TRAIN_MEM_SHARE * total:
        n -= 1
    return n


def train_family_phase(dev, small: bool = False) -> dict:
    """Phase 18: every family trained at full width in f32 (the smoke
    configs when ``small``), 4 x 1024 tokens a step, 1 MiB buckets, on
    the one-rank group: partitioned for 3 steps, bulk and per_leaf for
    1, each from the same weights and batches.  Depth is cut to
    ``TRAIN_FAMILY_LAYERS``, and further where the reckoned step
    (:func:`train_depth`) would leave less than a quarter of the card
    free; each cut is printed and listed.  Checks:
    all-reduces a step equal the plan's buckets plus the loss's,
    pack/unpack launches a step equal the plan's multi-leaf buckets, a
    finite step-0 loss within [0.5, 1.5] ln V, the same step-0 loss in
    the three modes and step-0 synced gradients within
    ``TRAIN_FAMILY_GRAD_TOL`` of their leaf's scale (per_leaf packs
    nothing, so partitioned and bulk are held against the sync without
    a pack kernel), on the card the pack and unpack
    kernels bitwise against their plain versions on every bucket of the
    step-0 gradients that partitioned and bulk pack, and the smoke
    config's step-0 gradients and losses on the card against the CPU.
    Reports step ms, tokens/s, peak memory, and from a profile of one
    more partitioned step the device idle share and the pack/unpack
    kernels' device ms."""
    import math
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import pipeline
    from repro_torch.kernels import bucket_pack as bp

    on_card = dev.type == "cuda"
    batch = 4
    total = torch.cuda.mem_get_info(dev)[1] if on_card else 0
    out, cuts = {}, []
    n_max = max(n for _, n in TRAIN_FAMILY_MODES)
    for arch in TRAIN_FAMILY_ARCHS:
        t_arch = time.perf_counter()
        cfg = (get_smoke_config if small else get_config)(arch).replace(
            param_dtype="float32")
        seq = (96 if small else 1024) if cfg.frontend == "vision_stub" \
            else (64 if small else 1024)
        if on_card and not small:
            depth = min(TRAIN_FAMILY_LAYERS,
                        train_depth(cfg, batch, seq, total))
            if depth < cfg.n_layers:
                cuts.append((arch, depth, cfg.n_layers))
                print(f"train {arch}: depth cut to {depth} of"
                      f" {cfg.n_layers} layers (reckoned"
                      f" {_train_bytes(cfg, batch, seq) / 1e9:.1f} GB at"
                      f" full depth,"
                      f" {_train_bytes(cfg.replace(n_layers=depth), batch, seq) / 1e9:.1f}"
                      f" GB cut, budget {TRAIN_MEM_SHARE * total / 1e9:.1f}"
                      f" GB; at most {TRAIN_FAMILY_LAYERS} layers)")
                cfg = cfg.replace(n_layers=depth)
        stream = pipeline.for_model(cfg, seq, batch)
        batches = [_train_batch(cfg, stream, i, dev)
                   for i in range(n_max + 1)]
        rec = {"layers": cfg.n_layers, "params": cfg.param_count(),
               "reckoned_gb": _train_bytes(cfg, batch, seq) / 1e9,
               "modes": {}}
        for key in bp.LAUNCHES:  # counts at 0 just before the path
            bp.LAUNCHES[key] = 0
        first = {}  # partitioned's step-0 loss and synced gradients
        for mode, n_steps in TRAIN_FAMILY_MODES:
            what = f"train {arch} {mode}"
            grads0 = _step0_against_first(first, rec["modes"], mode, what,
                                          tol=TRAIN_FAMILY_GRAD_TOL,
                                          leaf_scale=True)

            def at_step0(state, loss0, mode=mode, what=what, grads0=grads0):
                grads0(state, loss0)
                if on_card:
                    rec["modes"][mode]["pack_check"] = _pack_vs_plain(
                        state["params"], mode, TRAIN_AGGR, what)
            state, step, m = _train_mode(cfg, mode, n_steps, batches, dev,
                                         seq=seq, batch=batch,
                                         total_steps=n_max,
                                         at_step0=at_step0)
            lo, hi = 0.5 * math.log(cfg.vocab), 1.5 * math.log(cfg.vocab)
            check(lo <= m["losses"][0] <= hi,
                  f"{what}: step-0 loss {m['losses'][0]!r} outside"
                  f" [{lo:.3f}, {hi:.3f}]")
            check(mode != "per_leaf" or m["plan_multi"] == 0,
                  f"{what}: the plan packs {m['plan_multi']} buckets; the"
                  f" other modes' gradients are held against this one's as"
                  f" the sync without a pack kernel")
            if on_card and mode == "partitioned":
                wall, busy, events, evs = _device_split(
                    lambda: step(state, batches[n_steps]), dev)
                pk = [(t, c) for t, k, c in evs if "bucket_kernel" in k]
                m["profile"] = {
                    "wall_ms": wall, "busy_ms": busy,
                    "idle_share": 1 - busy / wall, "events": events,
                    "pack_ms": sum(t for t, _ in pk),
                    "pack_kernels": sum(c for _, c in pk),
                    "nccl_ms": sum(t for t, k, _ in evs if "nccl" in k.lower()),
                    "top": [(round(t, 3), k[:48]) for t, k, _ in evs[:4]]}
            rec["modes"][mode].update(m)
            del state, step
            if on_card:
                torch.cuda.empty_cache()
        rec["launches"] = dict(bp.LAUNCHES)  # read just after
        first.clear()
        check(not on_card or rec["launches"]["bucket_pack"] > 0,
              f"train {arch}: no pack kernel launched")
        part = rec["modes"]["partitioned"]
        ms = sorted(part["times_ms"][1:]) or part["times_ms"]
        rec["step_ms"] = ms[len(ms) // 2]
        rec["tokens_per_s"] = batch * seq / (rec["step_ms"] / 1e3)
        rec["peak_gib"] = max((m["peak_gib"] or 0.0)
                              for m in rec["modes"].values())
        prof = part.get("profile", {})
        print(f"train family {arch}{' smoke' if small else ''}"
              f" ({cfg.n_layers} layers, d {cfg.d_model}, {rec['params']}"
              f" parameters, reckoned {rec['reckoned_gb']:.1f} GB): "
              + "; ".join(
                  f"{mode} losses {m['losses']} ms"
                  f" {[round(t, 3) for t in m['times_ms']]} all-reduces"
                  f" {m['n_all_reduce']} (plan {m['plan_all_reduce'] - 1}"
                  f" + 1) pack/unpack {m['packs']}, step-0 gradients vs"
                  f" partitioned"
                  f" {'bitwise equal' if not m['grad_diff'] else m['grad_diff'][:3]}"
                  f", pack/unpack kernels vs plain bitwise on"
                  f" {m.get('pack_check')}"
                  for mode, m in rec["modes"].items())
              + f"; step {rec['step_ms']:.3f} ms (partitioned, median after"
              f" step 0), {rec['tokens_per_s']:.1f} tokens/s, peak"
              f" {rec['peak_gib']:.3f} GiB"
              f" ({rec['peak_gib'] * 2**30 / total if total else 0:.3f} of"
              f" the card); profile of one partitioned step:"
              f" wall {prof.get('wall_ms', float('nan')):.3f} ms, idle share"
              f" {prof.get('idle_share', float('nan')):.3f}, pack/unpack"
              f" kernels {prof.get('pack_ms', float('nan')):.3f} ms in"
              f" {prof.get('pack_kernels')} launches, nccl"
              f" {prof.get('nccl_ms', float('nan')):.3f} ms, top"
              f" {prof.get('top')}")
        if on_card:
            rec["cpu_vs_card"] = _cpu_vs_card(dev, arch)
        rec["wall_s"] = time.perf_counter() - t_arch
        out[arch] = rec
    print(f"train families: depth cuts {cuts or 'none'}")
    out["cuts"] = cuts
    return out


# ---------------------------------------------------------------------------
# Phase 19: partitioned communication on torch.distributed
# ---------------------------------------------------------------------------

# 19b: llama3.2-1b's decode attention at its 128k context, bf16 (B, H,
# Kv, D, S) and the cases (pos, window, softcap): the last position, an
# early one, gemma2-9b's window of 4096, and that window with gemma2's
# attention softcap of 50 at three quarters of the sequence.
DECODE_SHAPE = (1, 32, 8, 64, 131072)
DECODE_SHAPE_SMALL = (1, 8, 2, 16, 4096)
# 19c: logits through flash decode against the default decode, bf16:
# the rule of tests/test_torch_families_bf16.py (5 bf16 ulps at the
# logit scale, the ulp of the default path's largest |logit|).
DECODE_ULPS = 5
# 19c: the smoke configs decoded through flash decode, card against CPU.
FLASH_DECODE_SMOKE = (("gemma2-9b", {}), ("hymba-1.5b", {"n_layers": 4}))


def _bf16_ulp(x: float) -> float:
    """The bf16 ulp at magnitude ``x`` (8 significant bits)."""
    import math
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


def _collectives_check(dev, card: str, small: bool) -> None:
    """19a: every collective of ``core.chunked_collectives`` on one rank
    at 64 MiB of f32, and ``compress_with_feedback`` on the card against
    the CPU, bitwise."""
    import torch
    from repro_torch.core import chunked_collectives as cc
    from repro_torch.optim import grad_compress as gcm
    rows, cols = (64, 64) if small else (4096, 4096)
    x = _seeded((rows, cols), torch.float32, dev, 0)
    w = _seeded((cols, cols // 4), torch.float32, dev, 1)
    n = 0
    for c in (1, 2, 4):
        for name, got in (
                ("ring_all_gather tiled",
                 cc.ring_all_gather(x, n_channels=c, tiled=True)),
                ("ring_all_gather", cc.ring_all_gather(x, n_channels=c)[0]),
                ("ring_reduce_scatter",
                 cc.ring_reduce_scatter(x[None], n_channels=c)),
                ("ring_all_reduce", cc.ring_all_reduce(x, n_channels=c))):
            check(_same_bits(got, x), f"{name} at {c} channels differs"
                  f" from its input on one rank")
            n += 1
    check(_same_bits(cc.ring_all_reduce_q8(x), cc._dq8(*cc._q8(x))),
          "ring_all_reduce_q8 differs from quantize -> dequantize")
    xc = x.cpu()
    check(_same_bits(cc._q8(x)[1].cpu(), cc._q8(xc)[1])
          and _same_bits(cc.ring_all_reduce_q8(x).cpu(),
                         cc.ring_all_reduce_q8(xc)),
          "ring_all_reduce_q8: the card's scale differs from the CPU's")
    ref = x @ w
    check(_same_bits(cc.collective_ag_matmul(x, w), ref),
          "collective_ag_matmul differs from x @ w")
    check(_same_bits(cc.collective_matmul_rs(x, w), ref),
          "collective_matmul_rs differs from x @ w")
    leaves = {"w": torch.float32, "b": torch.bfloat16}
    ef_d = gcm.init_error_feedback({k: x for k in leaves})
    ef_c = {k: v.cpu() for k, v in ef_d.items()}
    for step in range(3):
        g = {k: _seeded((rows, cols), dt, dev, 10 + step)
             for k, dt in leaves.items()}
        sent_d, ef_d = gcm.compress_with_feedback(g, ef_d)
        sent_c, ef_c = gcm.compress_with_feedback(
            {k: v.cpu() for k, v in g.items()}, ef_c)
        for k in leaves:
            check(_same_bits(sent_d[k].cpu(), sent_c[k])
                  and _same_bits(ef_d[k].cpu(), ef_c[k]),
                  f"compress_with_feedback step {step} leaf {k}: the card"
                  f" differs from the CPU")
    print(f"[{card}] partitioned collectives, one rank, {rows}x{cols} f32"
          f" ({x.numel() * 4} bytes): all-gather (tiled, stacked),"
          f" reduce-scatter and all-reduce at 1, 2 and 4 channels equal"
          f" their input bitwise ({n} cases); ring_all_reduce_q8 equals"
          f" quantize -> dequantize and the CPU's, bitwise;"
          f" collective_ag_matmul and collective_matmul_rs equal x @ w"
          f" ({cols}x{cols // 4}) bitwise; compress_with_feedback over 3"
          f" steps on an f32 and a bf16 leaf equals the CPU's bitwise")


def _decode_breakdown(q, k, v, dev, reps: int, card: str) -> None:
    """Event times of flash decode's largest steps at the 128k shape:
    the f32 copy of K (and of V), the scores product Q.K in f32, the
    probabilities' product P.V in f32 as one product (the reference's
    and ``flash_decode_ref``'s) and in runs of ``PV_CHUNK`` keys
    (``flash_decode_shard``'s ``_pv``), and P.V in bf16
    (``masked_attention``'s)."""
    import torch
    from repro_torch.core import flash_decode as fd
    b, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, kv, h // kv, d).float()
    kf, vf = k.float(), v.float()
    p = torch.softmax(torch.einsum("bkgd,bskd->bkgs", qg, kf), dim=-1)
    pb = p.to(torch.bfloat16)
    parts = {
        "K to f32": lambda: k.float(),
        "Q.K f32": lambda: torch.einsum("bkgd,bskd->bkgs", qg, kf),
        "P.V f32 one product": lambda: torch.einsum("bkgs,bskd->bkgd", p,
                                                     vf),
        f"P.V f32 in runs of {fd.PV_CHUNK}": lambda: fd._pv(p, vf),
        "P.V bf16": lambda: torch.einsum("bkgs,bskd->bkgd", pb, v)}
    print(f"[{card}] flash decode steps at S {k.shape[1]}: "
          + ", ".join(f"{name} {_timed(fn, dev, reps):.4f} ms"
                      for name, fn in parts.items()))


def _decode_attention_check(dev, card: str, small: bool) -> None:
    """19b: ``flash_decode_shard`` on one rank against
    ``flash_decode_ref`` at llama3.2-1b's decode shape over its 128k
    context, bf16, each case with its CUDA-event time, the default
    ``masked_attention`` decode's beside it, and the byte bound."""
    import torch
    from repro_torch.core.flash_decode import (flash_decode_ref,
                                               flash_decode_shard)
    from repro_torch.models.attention import masked_attention
    b, h, kv, d, s = DECODE_SHAPE_SMALL if small else DECODE_SHAPE
    q = _seeded((b, h, d), torch.bfloat16, dev, 1)
    k = _seeded((b, s, kv, d), torch.bfloat16, dev, 2)
    v = _seeded((b, s, kv, d), torch.bfloat16, dev, 3)
    k_pos = torch.arange(s, device=dev)
    nbytes = 2 * (q.numel() * 2) + 2 * k.numel() * 2
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    reps = 10 if dev.type == "cuda" else 2
    tol = FLASH_TOL["bfloat16"]
    for pos, window, cap in ((s - 1, 0, None), (17, 0, None),
                             (s - 1, 4096, None), (3 * s // 4, 4096, 50.0)):
        kw = dict(pos=pos, window=window, attn_softcap=cap, scale=d ** -0.5)
        got = flash_decode_shard(q, k, v, **kw)
        want = flash_decode_ref(q, k, v, **kw)

        def masked():
            return masked_attention(
                q[:, None], k, v, q_pos=torch.full((b, 1), pos, device=dev),
                k_pos=k_pos, window=window, attn_softcap=cap,
                scale=d ** -0.5)[:, 0]
        err = float((got.float() - want.float()).abs().max())
        err_m = float((masked().float() - want.float()).abs().max())
        check(bool(torch.isfinite(got).all()) and bool(
            ((got.float() - want.float()).abs()
             <= tol + tol * want.float().abs()).all()),
              f"flash_decode_shard pos {pos} window {window} softcap {cap}"
              f" differs from flash_decode_ref by {err!r}")
        ms = _timed(lambda: flash_decode_shard(q, k, v, **kw), dev, reps)
        ref_ms = _timed(lambda: flash_decode_ref(q, k, v, **kw), dev, reps)
        masked_ms = _timed(masked, dev, reps)
        print(f"[{card}] flash decode B {b} H {h} Kv {kv} D {d} S {s} bf16,"
              f" pos {pos} window {window} softcap {cap}: max_abs_err vs"
              f" flash_decode_ref {err!r} (tol {tol}; masked_attention"
              f" {err_m!r}); flash_decode_shard {ms:.4f} ms,"
              f" flash_decode_ref {ref_ms:.4f} ms, masked_attention"
              f" decode {masked_ms:.4f} ms; bound {bound_ms:.4f} ms"
              f" (bytes: {nbytes})")
        if pos == s - 1 and not window:
            _decode_breakdown(q, k, v, dev, reps, card)


def _teacher_forced(cfg, scfg, model, prompts, gen, dev, *, group=None,
                    feed=None, reps: int = 1, mesh=None):
    """Prefill ``prompts``, then ``gen`` decode steps through
    ``make_decode_step`` (``group``: flash decode's; ``mesh``: the cache
    placed on it), each fed the token
    of ``feed`` (None: greedy, recorded).  Returns (the logits of every
    step, the fed tokens, the all-reduces of every step, the median
    decode ms a token over ``reps`` runs of the steps on the same cache,
    a callable running 8 of the steps)."""
    import torch
    from repro_torch import compat
    from repro_torch.launch.steps import (make_cache, make_decode_step,
                                          make_prefill_step)
    b, s = prompts.shape
    cache = make_cache(cfg, scfg, batch=b, max_len=s + gen, device=dev,
                       mesh=mesh)
    logits, cache = make_prefill_step(cfg, scfg, seq_len=s, batch=b,
                                      device=dev, mesh=mesh)(
        model, prompts, cache)
    step = make_decode_step(cfg, scfg, seq_len=s + gen, batch=b, device=dev,
                            group=group, mesh=mesh)
    fed = [] if feed is None else feed
    out, calls = [], []
    for i, t in enumerate(range(s, s + gen)):
        if feed is None:
            fed.append(logits[:, :cfg.vocab].argmax(-1))
        before = compat.CALLS["all_reduce"]
        logits, cache = step(model, cache, fed[i], t)
        calls.append(compat.CALLS["all_reduce"] - before)
        out.append(logits)

    def steps(n=gen):
        for i, t in enumerate(range(s, s + n)):
            step(model, cache, fed[i], t)
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / gen)
    return out, fed, calls, sorted(times)[len(times) // 2], \
        (lambda: steps(8))


def _flash_decode_serving(dev, card: str, small: bool) -> None:
    """19c: llama3.2-1b at full width in bf16 decoding through flash
    decode on one rank, teacher-forced from the default decode."""
    import torch
    from repro_torch import serve
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.steps import StepConfig
    cfg = (get_smoke_config if small else get_config)("llama3.2-1b")
    batch, prompt_len, gen = (2, 64, 8) if small else (4, 1024, 32)
    model = serve.build_model(cfg, 0, dev).to(torch.bfloat16)
    prompts = serve.make_prompts(cfg, batch, prompt_len, 2, dev)
    reps = 3 if dev.type == "cuda" else 1
    base, fed, calls0, base_ms, base8 = _teacher_forced(
        cfg, StepConfig(), model, prompts, gen, dev, reps=reps)
    fd, _, calls, fd_ms, fd8 = _teacher_forced(
        cfg, StepConfig(flash_decode=True), model, prompts, gen, dev,
        feed=fed, reps=reps)
    check(set(calls0) == {0}, f"default decode issued all-reduces {calls0}")
    check(calls == [3 * cfg.n_layers] * gen,
          f"flash decode issued {calls} all-reduces, not"
          f" {3 * cfg.n_layers} a step")
    worst = 0.0
    for i, (a, r) in enumerate(zip(fd, base)):
        a, r = a[:, :cfg.vocab].float(), r[:, :cfg.vocab].float()
        check(bool(torch.isfinite(a).all()), f"step {i}: logits not finite")
        ulps = float((a - r).abs().max()) / _bf16_ulp(float(r.abs().max()))
        worst = max(worst, ulps)
    check(worst <= DECODE_ULPS, f"flash decode logits {worst:.2f} bf16 ulps"
          f" from the default decode's (allowed {DECODE_ULPS})")
    idle = {}
    if dev.type == "cuda":
        for name, fn in (("default", base8), ("flash_decode", fd8)):
            wall, busy, _, _ = _device_split(fn, dev)
            idle[name] = 1 - busy / wall if wall > 0 else float("nan")
    name = "llama3.2-1b smoke" if small else "llama3.2-1b"
    print(f"[{card}] flash decode serving {name}"
          f" ({cfg.n_layers} layers) bf16, batch {batch}, {prompt_len}-token"
          f" prompts, {gen} teacher-forced decode steps on one rank:"
          f" logits within {worst:.2f} bf16 ulps of the default decode's"
          f" (allowed {DECODE_ULPS}); all_reduce a step {calls[0]} (3 x"
          f" {cfg.n_layers} layers); decode {fd_ms:.3f} ms a token with"
          f" flash_decode, {base_ms:.3f} ms without (median of {reps},"
          f" host clock); idle share of 8 steps {idle or 'not measured'}")


def _flash_decode_card_vs_cpu(dev, cpu_group, card: str) -> None:
    """19c: the smoke configs with windows and softcaps, decoded through
    flash decode in f32 on the card and on the CPU, within 2e-5."""
    import copy
    import torch
    from repro_torch import serve
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import StepConfig
    scfg = StepConfig(param_dtype="float32", cache_dtype="float32",
                      flash_decode=True)
    for arch, changes in FLASH_DECODE_SMOKE:
        cfg = get_smoke_config(arch).replace(**changes)
        cpu = serve.build_model(cfg, 0, "cpu")
        prompts = serve.make_prompts(cfg, 2, 24, 1, "cpu")
        want, fed, calls_c, _, _ = _teacher_forced(
            cfg, scfg, cpu, prompts, 4, torch.device("cpu"),
            group=cpu_group)
        got, _, calls, _, _ = _teacher_forced(
            cfg, scfg, copy.deepcopy(cpu).to(dev), prompts.to(dev), 4, dev,
            feed=[t.to(dev) for t in fed])
        err = 0.0
        for a, b in zip(got, want):
            a = a.cpu()
            check(bool(((a - b).abs() <= FAMILY_CARD_TOL
                        + FAMILY_CARD_TOL * b.abs()).all()),
                  f"{arch} smoke flash decode: the card differs from the"
                  f" CPU by {float((a - b).abs().max())!r}")
            err = max(err, float((a - b).abs().max()))
        check(calls == calls_c == [3 * cfg.n_layers] * 4,
              f"{arch} smoke: all-reduces {calls} on the card, {calls_c} on"
              f" the CPU")
        print(f"[{card}] flash decode {arch} smoke ({cfg.n_layers} layers,"
              f" windows {cfg.windows()}, softcap {cfg.attn_softcap}) f32,"
              f" 4 teacher-forced steps: card vs CPU max|d| {err!r} (tol"
              f" {FAMILY_CARD_TOL}), all_reduce a step {calls[0]}")


def partitioned_phase(dev, small: bool = False) -> None:
    """Phase 19: the partitioned collectives, the int8 ring and gradient
    compression (19a), flash decode at the 128k decode shape (19b) and
    decoding through it (19c), on a one-rank group of the default
    process group's backend (a one-rank gloo group beside it for the
    CPU side of 19c on the card)."""
    import torch.distributed as dist
    card = _card_name()
    on_card = dev.type == "cuda"
    cpu_group = dist.new_group(backend="gloo") if on_card else None
    t0 = time.perf_counter()
    _collectives_check(dev, card, small)
    print(f"[{card}] phase 19a wall {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    _decode_attention_check(dev, card, small)
    print(f"[{card}] phase 19b wall {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    _flash_decode_serving(dev, card, small)
    if on_card:
        _flash_decode_card_vs_cpu(dev, cpu_group, card)
    print(f"[{card}] phase 19c wall {time.perf_counter() - t0:.3f} s")


# Phase 20: the evaluation tooling.  The smoke throughput cells of the
# engines the card run gates (the scalar reference is measured only for
# the committed full document), the specs the spawned pool runs, and
# the chaos campaigns through the command line.
BENCH_PORT = ROOT / "BENCH_engine_torch.json"
BENCH_SMOKE_ENGINES = ("vector", "torch", "cuda")
JOBS_SPECS = ("fig5_contention", "halo1d")
TOOLING_CHAOS = 8


def _same_card(a: str, b: str) -> bool:
    """Two ``nvidia-smi`` name/power-limit strings of one card model."""
    return a.split(",")[0].strip() == b.split(",")[0].strip()


def tooling_phase(dev, baseline: dict, small: bool = False) -> dict:
    """Phase 20: the port's evaluation tooling on the card.  (a) the
    sweep's ``--bench-engine`` smoke cells on vector, torch and cuda
    (the XXL tier on torch and cuda only), gated 2x against the
    committed ``BENCH_engine_torch.json``; (b) ``run_specs`` with two
    spawned workers on engine cuda, bitwise the in-process run and on
    the baseline; (c) ``--profile`` of the XXL smoke tier, cold and
    warm, with the memo counters; (d) the benchmark harness's ``--fast``
    rows on cuda, equal in value to engine reference's; (e) the chaos
    command line.  Every line carries the card's name and power limit.
    ``small`` (a CPU rehearsal) leaves the XXL tier out of (a) and
    profiles the XL one."""
    import contextlib
    import io

    from repro_torch import chaos as chaos_cli
    from repro_torch import sweep
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.core import fabric_cuda as fc
    from repro_torch.experiments import SPECS, compare_to_baseline, run_specs
    from repro_torch.experiments import engine as exp_engine
    card = _card_name()
    on_card = dev.type == "cuda"
    out = {}

    # (a) engine throughput, measured by the command line in a fresh
    # process, as the committed document was: after phases 1-19 one
    # process times the short cells differently (on an H100 the
    # 27 648-event weak_scaling smoke cell's cuda/torch ratio read 1.61
    # there, 3.37 and 3.54 in fresh processes)
    t0 = time.perf_counter()
    if on_card:
        import torch
        torch.cuda.empty_cache()
    src = Path(sweep.__file__).resolve().parents[1]
    names = [s.name for s in SPECS.values()
             if not (small and s.name == "weak_scaling_xxl")]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "bench.json"
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.sweep", "--bench-engine",
             "--smoke", "--bench-engines", ",".join(BENCH_SMOKE_ENGINES),
             "--specs", ",".join(names), "--device", dev.type,
             "--bench-out", str(path)],
            env={**os.environ, "PYTHONPATH": str(src)}, capture_output=True,
            text=True, timeout=900)
        print(proc.stdout, end="")
        check(proc.returncode == 0, f"sweep --bench-engine exited"
              f" {proc.returncode}: {proc.stderr[-2000:]}")
        doc = json.loads(path.read_text())
    cells = {(e["spec"], e["engine"]): e for e in doc["entries"]}
    tiers = ("weak_scaling", "weak_scaling_xl") + (
        () if small else ("weak_scaling_xxl",))
    for tier in tiers:
        n = cells[(tier, "cuda")]["launches"]
        check(n >= 1 or not on_card, f"bench {tier}/cuda: {n} launches")
    speedups = {k: v for k, v in doc["totals"].items()
                if k.startswith("speedup_")}
    check(set(speedups) == {"speedup_torch_vs_vector",
                            "speedup_cuda_vs_torch"}, f"{speedups}")
    if on_card:
        committed = json.loads(BENCH_PORT.read_text())
        check(_same_card(committed["device"], doc["device"]),
              f"bench: measured on {doc['device']!r}, committed on"
              f" {committed['device']!r}")
        violations = sweep.check_bench_regression(
            doc, {**committed, "device": doc["device"]})
        check(not violations, "bench: " + "; ".join(violations))
        gate = (f"2x gate against {BENCH_PORT.name} (committed on"
                f" {committed['device']}) passed")
    else:
        gate = "no gate on the CPU"
    print(f"[{card}] bench-engine smoke: {len(doc['entries'])} cells, "
          + ", ".join(f"{k[8:]} {v:.2f}x" for k, v in speedups.items())
          + f"; {gate}; wall {time.perf_counter() - t0:.3f} s")
    out["bench"] = doc

    # (b) two spawned workers against the in-process run
    t0 = time.perf_counter()
    jspecs = [SPECS[n] for n in JOBS_SPECS]
    exp_engine._CACHE.clear()
    one = run_specs(jspecs, mode="full", engine="cuda", device=dev)
    t_one = time.perf_counter() - t0
    exp_engine._CACHE.clear()
    t0 = time.perf_counter()
    two = run_specs(jspecs, mode="full", engine="cuda", device=dev, jobs=2)
    t_two = time.perf_counter() - t0
    exp_engine._CACHE.clear()
    check(json.dumps(two, sort_keys=True) == json.dumps(one, sort_keys=True),
          "--jobs 2 records differ from --jobs 1")
    v = compare_to_baseline(baseline, two)
    check(not v, "--jobs 2 baseline drift: " + "; ".join(v[:5]))
    n = sum(len(r) for r in two.values())
    print(f"[{card}] run_specs {', '.join(JOBS_SPECS)} full (cuda): {n}"
          f" records, --jobs 2 (spawned workers) bitwise --jobs 1 and on"
          f" the baseline; wall {t_one:.3f} s in process, {t_two:.3f} s"
          f" with 2 workers")

    # (c) --profile of the XXL smoke tier
    tier = "weak_scaling_xl" if small else "weak_scaling_xxl"
    results, prof = sweep.profile_specs([SPECS[tier]], "smoke", "cuda", dev)
    v = compare_to_baseline(baseline, results)
    check(not v, f"profile {tier}: " + "; ".join(v))
    check(prof["launches"] >= 2 or not on_card,
          f"profile {tier}: {prof['launches']} launches")
    lines = io.StringIO()
    sweep.print_profile(prof, lines)
    for line in lines.getvalue().splitlines():
        print(f"[{card}] profile {tier} smoke (cuda) {line}")
    out["profile"] = prof

    # (d) the harness's --fast rows, cuda against reference
    t0 = time.perf_counter()
    before = fc.LAUNCHES["fabric_scan"]
    csv = io.StringIO()
    with contextlib.redirect_stdout(csv):
        rc = bench_run.main(["--fast", "--engine", "cuda", "--device",
                             str(dev)])
    t_cuda = time.perf_counter() - t0
    launches = fc.LAUNCHES["fabric_scan"] - before
    check(rc == 0, f"benchmarks.run exited {rc}")
    t0 = time.perf_counter()
    want = bench_run.collect(0, "reference", "cpu")
    t_ref = time.perf_counter() - t0
    got = bench_run.collect(0, "cuda", str(dev))
    check(got == want, "benchmarks.run --fast: cuda rows differ from"
          " reference: " + str([(a, b) for a, b in zip(got, want)
                                if a != b][:3]))
    check(bench_run.scenario_results(0, "cuda", str(dev))
          == bench_run.scenario_results(0, "reference", "cpu"),
          "benchmarks.run --json: cuda results differ from reference")
    rows = csv.getvalue().splitlines()
    check(len(rows) == 1 + len(want) == 289, f"{len(rows)} CSV lines")
    check(all(x == x and abs(x) != float("inf") for _, x, _ in got),
          "benchmarks.run: a value is not finite")
    print(f"[{card}] benchmarks.run --fast (cuda): {len(got)} rows equal"
          f" in value to engine reference's, fabric_scan launches"
          f" {launches}; wall {t_cuda:.3f} s (reference {t_ref:.3f} s)")

    # (e) the chaos command line
    t0 = time.perf_counter()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = chaos_cli.main(["--campaigns", str(TOOLING_CHAOS), "--device",
                             str(dev)])
    check(rc == 0 and "0 violations" in text.getvalue(),
          f"chaos exited {rc}: {text.getvalue()[-500:]}")
    print(f"[{card}] {text.getvalue().strip()}; wall"
          f" {time.perf_counter() - t0:.3f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 21: the float32 mode of the fabric engines and the mesh layer
# ---------------------------------------------------------------------------

# 21a: float32 against the float64 oracle (tests/_engines.py's contract):
# times within F32_RTOL of the record's largest time, rates and ratios
# of two times within twice that, counters exact.
F32_RTOL = 1e-4
F32_EXACT_SUFFIXES = ("_bytes", "_kept", "_factor", "bytes_max",
                      "bytes_min")


def _f32_violations(got: dict, want: dict) -> list:
    """Where float32 records leave the float64 oracle's tolerance."""
    bad = []
    for spec, recs in want.items():
        for key, m in recs.items():
            g = got[spec][key]
            us = max([abs(v) for k, v in m.items() if k.endswith("_us")]
                     or [0.0])
            for k, v in m.items():
                if k.startswith(("n_", "plan_")) or k.endswith(
                        F32_EXACT_SUFFIXES):
                    ok = g[k] == v
                elif k.endswith("_us"):
                    ok = abs(g[k] - v) <= F32_RTOL * us
                else:
                    ok = abs(g[k] - v) <= 2 * F32_RTOL * abs(v)
                if not ok:
                    bad.append(f"{spec}/{key} {k}: {g[k]!r} vs {v!r}")
    return bad


def _scan_cost(ops):
    """(bytes, operations, bound ms, bound_by) of a super-batch at its
    operands' float width, against HBM and the rate of that type."""
    import torch
    rate = FP64_OPS_PER_S if ops.t_ready.dtype == torch.float64 \
        else F32_FLOPS
    nbytes, nops = _scan_bytes(ops), _scan_ops(ops)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, nops / rate
    return nbytes, nops, max(t_b, t_o) * 1e3, \
        ("bytes" if t_b >= t_o else "operations")


def f32_phase(dev, baseline: dict) -> dict:
    """Phase 21a: the fabric engines' float32 mode on the card.  Returns
    the float32 kernel's row of the kernel table."""
    import torch
    from repro_torch import compat
    from repro_torch.core import fabric as fb
    from repro_torch.core import fabric_cuda as fc
    from repro_torch.core import simulator as sim
    from repro_torch.experiments import SPECS, run_spec
    from repro_torch.experiments import engine as exp_engine
    card, on_card = _card_name(), dev.type == "cuda"
    xxl = SPECS["weak_scaling_xxl"]

    def cold():
        exp_engine._CACHE.clear()
        sim.clear_merge_memo()

    def run_all(engine):
        out = {}
        for name in SCENARIO_LAUNCHES:
            cold()
            out[name] = run_spec(SPECS[name], "full", engine=engine,
                                 device=dev)
        cold()
        out[xxl.name] = run_spec(xxl, "smoke", engine=engine, device=dev)
        return out

    t0 = time.perf_counter()
    want = run_all("cuda")
    n_rec = sum(len(r) for r in want.values())
    check(n_rec == 155 + len(want[xxl.name]),
          f"phase 21a: {n_rec} oracle records")

    # the float32 main path: the XXL smoke tier, counts read around it
    for k in fc.LAUNCHES:
        fc.LAUNCHES[k] = 0
    with compat.x64_mode(False):
        cold()
        main = {xxl.name: run_spec(xxl, "smoke", engine="cuda", device=dev)}
    launches = fc.LAUNCHES["fabric_scan_f32"]
    check(launches > 0 or not on_card,
          "the float32 path did not launch fabric_scan_f32")
    check(fc.LAUNCHES["fabric_scan_f64"] == 0,
          "the float32 path launched the float64 kernel")
    bad = _f32_violations(main, {xxl.name: want[xxl.name]})
    check(not bad, "float32 XXL smoke: " + "; ".join(bad[:5]))

    # every float32 launch against its plain version, bitwise
    real, checked = fc.fabric_scan, []

    def checking(ops):
        out = real(ops)
        check(ops.t_ready.dtype == torch.float32,
              f"a {ops.t_ready.dtype} super-batch in the float32 mode")
        check(_outputs_equal(out, fc.fabric_scan_ref(ops)),
              f"fabric_scan_f32 differs from its plain version on a"
              f" super-batch of {ops.n} messages")
        checked.append(ops.n)
        return out
    got, per_engine = {}, {}
    fc.fabric_scan = checking
    try:
        with compat.x64_mode(False):
            for engine in ("torch", "cuda"):
                before = len(checked)
                got[engine] = run_all(engine)
                bad = _f32_violations(got[engine], want)
                check(not bad, f"float32 on {engine}: " + "; ".join(bad[:5]))
                per_engine[engine] = len(checked) - before
            cutoffs = fb.SCALAR_BATCH_CUTOFF, fb.MIN_GROUP_PARALLELISM
            fb.SCALAR_BATCH_CUTOFF = fb.MIN_GROUP_PARALLELISM = 0
            before = len(checked)
            try:
                forced = {}
                for name in FORCED_SPECS:
                    points = [p for p in SPECS[name].points("smoke")
                              if p.get("fault_rate", 0.0) == 0.0]
                    cold()
                    forced[name] = exp_engine.run_records(
                        SPECS[name].runner, points, engine="cuda",
                        device=dev)
            finally:
                fb.SCALAR_BATCH_CUTOFF, fb.MIN_GROUP_PARALLELISM = cutoffs
            per_engine["forced"] = len(checked) - before
    finally:
        fc.fabric_scan = real
    check(per_engine["torch"] == 0, "engine torch called the kernel")
    check(per_engine["cuda"] > 0 and per_engine["forced"] > 0,
          f"float32 kernel calls checked: {per_engine}")
    forced64 = {}
    for name in FORCED_SPECS:
        points = [p for p in SPECS[name].points("smoke")
                  if p.get("fault_rate", 0.0) == 0.0]
        cold()
        forced64[name] = exp_engine.run_records(
            SPECS[name].runner, points, engine="reference", device=dev)
    bad = _f32_violations(forced, forced64)
    check(not bad, "float32 forced records: " + "; ".join(bad[:5]))

    # float64 again in the same process: bitwise the first pass
    again = run_all("cuda")
    check(again == want, "float64 after float32 differs from the first"
          " float64 pass (an operand memo crossed the modes)")
    wall = time.perf_counter() - t0
    print(f"[{card}] float32 mode: XXL smoke on cuda {len(main[xxl.name])}"
          f" records, fabric_scan_f32 launches {launches} (float64"
          f" launches 0); the 13 scenario grids and the XXL smoke tier"
          f" ({n_rec} records) on torch and cuda and the forced smoke"
          f" records of {len(forced)} drivers within {F32_RTOL} of the"
          f" float64 oracle, counters exact; {len(checked)} float32"
          f" kernel calls bitwise equal to fabric_scan_ref ({per_engine});"
          f" float64 after float32 bitwise; wall {wall:.3f} s")

    # times at the XXL super-batch, float64 and float32 in turns
    pts = [_smoke_point(xxl, ap) for ap in ("pt2pt_single", "part")]
    items, fins = _grid(pts)
    reps = 20 if on_card else 3
    row, line = {}, []
    for x64 in (True, False, False, True):
        with compat.x64_mode(x64):
            ops, _ = fc.grid_ops(items, fins, dev)
        ms = _timed(lambda: fc.fabric_scan(ops), dev, reps)
        dev_ms = "not measured"
        if on_card:  # a finish launch is two device events: memset, kernel
            per_call, n_ev, _, _ = _device_profile(
                lambda: fc.fabric_scan(ops), 10, expect=20)
            if n_ev == 20:
                dev_ms = f"{per_call:.4f} ms"
        nbytes, nops, bound, by = _scan_cost(ops)
        tag = "f64" if x64 else "f32"
        line.append(f"{tag} event {ms:.4f} ms, device {dev_ms}, bound"
                    f" {bound:.4f} ms ({nbytes} bytes, {nops} ops, {by})")
        if not x64 and "ms" not in row:
            err = _max_abs_err(fc.fabric_scan(ops), fc.fabric_scan_ref(ops))
            plain = _timed(lambda: fc.fabric_scan_ref(ops), dev,
                           max(3, reps // 4))
            row = {"name": "fabric_scan_f32", "route": "cuda",
                   "source": "src/repro_torch/csrc/fabric_scan.cu",
                   "replaces": "src/repro/core/fabric_pallas.py:434",
                   "launches": launches, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                   "library_ms": None}
    print(f"[{card}] times XXL super-batch ({ops.n} messages), float64 and"
          f" float32 in turns: " + "; ".join(line)
          + f"; fabric_scan_ref in float32 {row['plain_ms']:.4f} ms")
    return row


def mesh_phase(dev, train_losses, small: bool = False) -> None:
    """Phase 21b: the mesh layer on a (1, 1) ``DeviceMesh`` over the
    one-rank group: ZeRO-1 training and the sequence-sharded cache's
    decode cell, each bitwise against the unsharded path."""
    import torch
    from repro_torch import serve
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import pipeline
    from repro_torch.kernels import bucket_pack as bp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import param_leaves
    card, on_card = _card_name(), dev.type == "cuda"
    mesh = make_mesh((1, 1), ("data", "model"), dev)

    # ZeRO-1: 3 steps against 3 unsharded steps, phase 13's config
    arch = "llama3.2-1b"
    cfg = (get_smoke_config if small else get_config)(arch).replace(
        param_dtype="float32")
    batch, seq = (4, 64) if small else (4, 1024)
    stream = pipeline.for_model(cfg, seq, batch)
    n_steps, total = 3, max(n for _, n in TRAIN_MODES)
    data = [steps.batch_to_device(stream.batch(i), dev)
            for i in range(n_steps)]
    scfg = steps.StepConfig(sync_mode="partitioned", aggr_bytes=TRAIN_AGGR,
                            param_dtype="float32", warmup_steps=1,
                            total_steps=total)
    runs = {}
    for name, mesh_ in (("unsharded", None), ("zero1", mesh)):
        for k in bp.LAUNCHES:
            bp.LAUNCHES[k] = 0
        state = steps.build_state(cfg, 0, dev, scfg.adam, mesh=mesh_)
        step = steps.make_train_step(cfg, scfg, seq_len=seq, batch=batch,
                                     device=dev, mesh=mesh_)
        losses, times = [], []
        for b in data:
            _sync(dev)
            t0 = time.perf_counter()
            state, loss = step(state, b)
            losses.append(loss.item())
            _sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        runs[name] = (state, losses, times, dict(bp.LAUNCHES))
    (plain, l_u, t_u, _), (zero, l_z, t_z, launches_z) = \
        runs["unsharded"], runs["zero1"]
    check(l_z == l_u, f"ZeRO-1 losses {l_z} != unsharded {l_u}")
    check(not train_losses or l_z == train_losses[:n_steps],
          f"ZeRO-1 losses {l_z} != phase 13's {train_losses[:n_steps]}")
    pz = dict(zero["params"].named_parameters())
    check(all(_same_bits(p, pz[k]) for k, p in
              plain["params"].named_parameters()),
          "ZeRO-1 parameters differ from the unsharded step's")
    for key in ("m", "v"):
        for leaf, segs in param_leaves(plain["opt"][key].items()):
            whole = torch.stack(segs) if leaf.startswith("layers.") \
                else segs[0]
            check(_same_bits(whole, zero["opt"][key][leaf].to_local()),
                  f"ZeRO-1 moment {key} {leaf} differs")
    check(not on_card or launches_z["bucket_pack"] > 0,
          "the ZeRO-1 path launched no pack kernel")
    del runs, plain, zero, pz
    if on_card:
        torch.cuda.empty_cache()
    print(f"[{card}] ZeRO-1 {cfg.name} f32 on a (1, 1) mesh, {batch} x"
          f" {seq} tokens: {n_steps} steps bitwise equal to the unsharded"
          f" step's (losses {l_z}, parameters and both moments) and to"
          f" phase 13's losses; step ms {[round(t, 3) for t in t_z]}"
          f" (unsharded {[round(t, 3) for t in t_u]}); pack/unpack"
          f" launches {launches_z}")

    # the decode cell of phase 19 with the cache placed on the mesh
    cfg = (get_smoke_config if small else get_config)(arch)
    batch, prompt_len, gen = (2, 64, 8) if small else (4, 1024, 32)
    model = serve.build_model(cfg, 0, dev).to(torch.bfloat16)
    prompts = serve.make_prompts(cfg, batch, prompt_len, 2, dev)
    scfg = steps.StepConfig(flash_decode=True)
    want, fed, _, ms_r, _ = _teacher_forced(cfg, scfg, model, prompts, gen,
                                            dev, reps=1)
    for k in fa.LAUNCHES:
        fa.LAUNCHES[k] = 0
    got, _, calls, ms_m, _ = _teacher_forced(cfg, scfg, model, prompts, gen,
                                             dev, feed=fed, reps=1,
                                             mesh=mesh)
    flash = fa.LAUNCHES["flash_attention"]
    check(not on_card or flash > 0, "the mesh decode cell launched no"
          " flash kernel in its prefill")
    # the flash decode's 3 a layer, and the tensor-parallel forward's on
    # the one-rank model group: the mixer's and the FFN's a layer and the
    # embedding's
    check(calls == [3 * cfg.n_layers + 2 * cfg.n_layers + 1] * gen,
          f"mesh flash decode issued {calls} all-reduces")
    check(all(_same_bits(a, b) for a, b in zip(got, want)),
          "mesh-placed cache logits differ from the replicated cache's")
    print(f"[{card}] sequence-sharded cache on a (1, 1) mesh: {cfg.name}"
          f" bf16, {batch} prompts of {prompt_len}, {gen} flash-decode"
          f" steps, logits bitwise equal to the replicated cache's;"
          f" all_reduce a step {calls[0]}; flash launches {flash}; decode"
          f" {ms_m:.3f} ms a token on the mesh, {ms_r:.3f} ms replicated"
          f" (host clock, one run)")


# ---------------------------------------------------------------------------
# Phase 22: the tensor- and expert-parallel serving forward
# ---------------------------------------------------------------------------

# 22a: the archs served on the TP code path over the one-rank group, in
# the order they run (GQA, MoE, Mamba-2, MLA, the hybrid), and 22b's on
# two gloo ranks of the one card.
TP_ARCHS = ("llama3.2-1b", "granite-moe-3b-a800m", "mamba2-780m",
            "minicpm3-4b", "hymba-1.5b")
TP2_ARCHS = ("llama3.2-1b", "granite-moe-3b-a800m")
TP_BATCH, TP_PROMPT, TP_GEN = 4, 1024, 8
# Depth cuts of the full-width configs, to keep phase 22 within its
# minute (None: every layer).
TP_LAYERS = {"minicpm3-4b": 16, "hymba-1.5b": 16, "granite-moe-3b-a800m": 16,
             "mamba2-780m": 24}
# 22b against the unsharded path: the rule of test_torch_families_bf16.py,
# 5 bf16 ulps at the logit scale (the ulp of the largest |logit|).
TP_BF16_ULPS = 5
TP2_TIMEOUT_S = 240
# 22b, MoE: the router logits of the TP run and of the unsharded one on
# the same routes, in bf16 ulps of each token's largest |logit|.  The
# two runs' hidden states differ by bf16 roundings only, so their
# router logits by a few ulps; a wrong expert block or token order
# moves them by the logits' whole scale (128 ulps and more).
TP_ROUTER_ULPS = 64


def _tp_config(arch: str, small: bool):
    from repro_torch.configs import get_config, get_smoke_config
    if small:
        return get_smoke_config(arch)
    cfg = get_config(arch)
    if TP_LAYERS.get(arch):
        cfg = cfg.replace(n_layers=TP_LAYERS[arch])
    return cfg


def _gqa_layers(cfg) -> int:
    return cfg.n_layers if cfg.mixer in ("attn", "hybrid") \
        and cfg.mla is None else 0


def _tp_serve(cfg, scfg, model, prompts, dev, *, feed=None, mesh=None,
              timer=None, repeat: bool = True):
    """A prefill of ``prompts`` and ``TP_GEN`` decode steps (fed
    ``feed``, or greedy and recorded) through the serving steps, each
    timed on the host clock (synchronised); with ``repeat`` timed again
    on the same cache, the first pass untimed.  Returns (logits of
    every step, fed tokens, flash launches of one prefill, prefill ms,
    decode ms a token (median of the steps), the collective ms of the
    timed prefill and of a timed decode step if ``timer``)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    b, s = prompts.shape[:2]
    cache = steps.make_cache(cfg, scfg, batch=b, max_len=s + TP_GEN,
                             device=dev, mesh=mesh)
    pre = steps.make_prefill_step(cfg, scfg, seq_len=s, batch=b, device=dev,
                                  mesh=mesh)
    dec = steps.make_decode_step(cfg, scfg, seq_len=s + TP_GEN, batch=b,
                                 device=dev, mesh=mesh)
    fed = [] if feed is None else feed
    out, times, coll = [], [], {"prefill": None, "decode": None}

    def timed(fn):
        _sync(dev)
        if timer is not None:
            timer.clear()
        t0 = time.perf_counter()
        r = fn()
        _sync(dev)
        times.append(((time.perf_counter() - t0) * 1e3,
                      timer.total() if timer is not None else None))
        return r
    before = fa.LAUNCHES["flash_attention"]
    logits, _ = timed(lambda: pre(model, prompts, cache))
    flash = fa.LAUNCHES["flash_attention"] - before
    out.append(logits)
    for i in range(TP_GEN):
        if feed is None:
            fed.append(logits[:, :cfg.vocab].argmax(-1))
        logits, _ = timed(lambda: dec(model, cache, fed[i], s + i))
        out.append(logits)
    if repeat:
        times.clear()
        timed(lambda: pre(model, prompts, cache))
        for i in range(TP_GEN):
            timed(lambda: dec(model, cache, fed[i], s + i))
    pre_ms, coll["prefill"] = times[0]
    steps_ = sorted(times[1:])
    dec_ms, coll["decode"] = steps_[len(steps_) // 2]
    return out, fed, flash, pre_ms, dec_ms, coll


def _same_logits(a, b) -> bool:
    return all(_same_bits(x, y) for x, y in zip(a, b))


def tp_phase(dev, small: bool = False) -> dict:
    """22a: the tensor- and expert-parallel code path over a (1, 1)
    ``DeviceMesh`` on the one-rank group: each of :data:`TP_ARCHS` at
    full width in bf16 (depth cut by :data:`TP_LAYERS`), a prefill of
    4 x 1024 tokens and 8 decode steps through ``make_prefill_step`` /
    ``make_decode_step(mesh=)`` with the model's blocks from
    ``convert.tp_shard_model``, the logits bitwise equal to the
    unsharded steps' and the flash kernel launched once a GQA layer in
    each prefill.  Returns per arch the times and launches."""
    import torch
    from repro_torch import serve
    from repro_torch.compat import psum_
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import axis_group, make_mesh
    from repro_torch.models import convert
    card, on_card = _card_name(), dev.type == "cuda"
    mesh = make_mesh((1, 1), ("data", "model"), dev)
    psum_(torch.ones(1, device=dev), axis_group(mesh, "model"))  # warm
    scfg = steps.StepConfig()
    batch, prompt = (2, 64) if small else (TP_BATCH, TP_PROMPT)
    out = {}
    for arch in TP_ARCHS:
        cfg = _tp_config(arch, small)
        model = serve.build_model(cfg, 0, dev, torch.bfloat16)
        prompts = serve.make_prompts(cfg, batch, prompt, 3, dev)
        want, fed, flash_u, pre_u, dec_u, _ = _tp_serve(
            cfg, scfg, model, prompts, dev, repeat=False)
        local = convert.tp_shard_model(model, cfg, mesh)
        del model
        got, _, flash, pre_ms, dec_ms, _ = _tp_serve(
            cfg, scfg, local, prompts, dev, feed=fed, mesh=mesh,
            repeat=False)
        del local
        if on_card:
            torch.cuda.empty_cache()
        check(_same_logits(got, want),
              f"22a {arch}: TP logits on the one-rank group differ from the"
              f" unsharded steps' (max |d| "
              f"{max(float((a - b).abs().max()) for a, b in zip(got, want))})")
        check(all(bool(torch.isfinite(g[:, :cfg.vocab]).all()) for g in got),
              f"22a {arch}: non-finite logits")
        check(not on_card or flash == _gqa_layers(cfg) == flash_u,
              f"22a {arch}: {flash} flash launches in a TP prefill,"
              f" {flash_u} unsharded, {_gqa_layers(cfg)} GQA layers")
        out[arch] = {"layers": cfg.n_layers, "flash": flash,
                     "prefill_ms": pre_ms, "decode_ms": dec_ms,
                     "unsharded_prefill_ms": pre_u,
                     "unsharded_decode_ms": dec_u}
        print(f"[{card}] 22a {arch} ({cfg.n_layers} layers, bf16, {batch} x"
              f" {prompt}): TP on a (1, 1) mesh, {TP_GEN} decode steps,"
              f" logits bitwise equal to the unsharded steps'; flash"
              f" launches a prefill {flash} ({_gqa_layers(cfg)} GQA"
              f" layers); prefill {pre_ms:.3f} ms (unsharded"
              f" {pre_u:.3f}), decode {dec_ms:.3f} ms a token (unsharded"
              f" {dec_u:.3f}; host clock, one pass each, the unsharded"
              f" first)")
    return out


class _CollectiveTimer:
    """Host milliseconds inside the collectives of ``repro_torch.compat``
    (each call synchronised on both sides), installed around
    ``torch.distributed``'s all-reduce and the single-tensor gather and
    reduce-scatter that ``compat`` calls."""

    def __init__(self, dev):
        import torch.distributed as dist
        from repro_torch import compat
        self.ms, self.dev = [], dev
        self._orig = (dist.all_reduce, compat._GATHER, compat._SCATTER)

        def wrap(fn):
            def timed(*a, **kw):
                _sync(dev)
                t0 = time.perf_counter()
                r = fn(*a, **kw)
                _sync(dev)
                self.ms.append((time.perf_counter() - t0) * 1e3)
                return r
            return timed
        dist.all_reduce = wrap(dist.all_reduce)
        compat._GATHER = wrap(compat._GATHER)
        compat._SCATTER = wrap(compat._SCATTER)

    def clear(self):
        self.ms.clear()

    def total(self) -> float:
        return sum(self.ms)

    def close(self):
        import torch.distributed as dist
        from repro_torch import compat
        dist.all_reduce, compat._GATHER, compat._SCATTER = self._orig


class _RouteLog:
    """The router logits and experts of every MoE router call
    (``moe.router_top_k``): recorded, or, with ``forced`` (a recorded
    log), replaced by the recorded experts, with the disagreement
    between this run's router logits and the recorded ones measured in
    bf16 ulps of each token's largest |logit|.  22b forces the unsharded
    reference of an MoE arch onto the TP run's routes: bf16 sums of
    partial outputs round apart from the unsharded products, the router
    logits move by a few ulps, and a token whose k-th and (k+1)-th
    experts lie closer than that routes either way
    (``tests/test_torch_families_bf16.py``), which moves its output by a
    whole expert's share."""

    def __init__(self, forced=None):
        from repro_torch.models import moe
        self.calls, self.forced, self.i = [], forced, 0
        self.differ, self.tokens, self.max_ulps = 0, 0, 0.0
        self._orig = moe.router_top_k
        moe.router_top_k = self._spy

    def _spy(self, p, xc, mo):
        import torch
        vals, idx = self._orig(p, xc, mo)
        logits = (xc @ p.router.to(xc.dtype)).float()[:, :mo.n_experts]
        if self.forced is None:
            self.calls.append((logits.cpu(), idx.cpu()))
            return vals, idx
        theirs, want = (t.to(idx.device) for t in self.forced[self.i])
        self.i += 1
        scale = logits.abs().amax(-1).clamp_min(1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
        self.max_ulps = max(self.max_ulps, float(
            ((logits - theirs).abs().amax(-1) / ulp).max()))
        self.differ += int((idx.sort(-1).values != want.sort(-1).values)
                           .any(-1).sum())
        self.tokens += idx.shape[0]
        return logits.gather(-1, want), want

    def close(self):
        from repro_torch.models import moe
        moe.router_top_k = self._orig


def tp_rank_main(rank: int, n: int, store: str, out_dir: str,
                 device: str, small: bool) -> None:
    """One of 22b's ranks: a (1, ``n``) mesh over a ``gloo`` group of
    ``n`` processes sharing the one card, made at once; then, when
    ``out_dir/go`` appears (the parent is done timing 22a), each arch of
    :data:`TP2_ARCHS` at ``cfg.with_tp(n)`` built from the seed and cut
    to this rank's blocks, a prefill and ``TP_GEN`` greedy decode steps
    with ``flash_decode`` off, then the same tokens with it on, each
    step timed with the collectives' share.  Writes ``rank<r>.json`` and
    its logits, fed tokens and router log of each pass
    (``logits<r>-<arch>-fd<0|1>.pt``, ``feed<r>-<arch>.pt``,
    ``routes<r>-<arch>-fd<0|1>.pt``)."""
    import torch
    import torch.distributed as dist
    from repro_torch import serve
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import convert
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    dist.init_process_group("gloo", store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    out, report = Path(out_dir), {}
    try:
        mesh = make_mesh((1, n), ("data", "model"), dev)
        timer = _CollectiveTimer(dev)
        t0 = time.perf_counter()
        while not (out / "go").exists():
            if time.perf_counter() - t0 > TP2_TIMEOUT_S:
                raise TimeoutError("22b: the parent never said go")
            time.sleep(0.05)
        for arch in TP2_ARCHS:
            cfg = _tp_config(arch, small).with_tp(n)
            full = serve.build_model(cfg, 0, dev, torch.bfloat16)
            local = convert.tp_shard_model(full, cfg, mesh)
            del full
            b, s = (2, 64) if small else (TP_BATCH, TP_PROMPT)
            prompts = serve.make_prompts(cfg, b, s, 3, dev)
            rec, feed = {}, None
            for fd in (False, True):
                scfg = steps.StepConfig(flash_decode=fd)
                routes = _RouteLog()
                try:  # one pass each: flash decode off warms the process
                    logits, feed, flash, pre_ms, dec_ms, coll = _tp_serve(
                        cfg, scfg, local, prompts, dev, feed=feed,
                        mesh=mesh, timer=timer, repeat=False)
                finally:
                    routes.close()
                torch.save([x.cpu() for x in logits],
                           out / f"logits{rank}-{arch}-fd{int(fd)}.pt")
                if routes.calls:
                    torch.save(routes.calls, out / f"routes{rank}-{arch}"
                               f"-fd{int(fd)}.pt")
                rec[f"fd{int(fd)}"] = {
                    "flash": flash, "prefill_ms": pre_ms,
                    "decode_ms": dec_ms,
                    "prefill_collective_ms": coll["prefill"],
                    "decode_collective_ms": coll["decode"]}
            torch.save([t.cpu() for t in feed], out / f"feed{rank}-{arch}.pt")
            report[arch] = rec
            del local
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        timer.close()
    finally:
        (out / f"rank{rank}.json").write_text(json.dumps(report))
        dist.destroy_process_group()


def tp_ranks_start(dev, tmp: str, small: bool = False) -> list:
    """Start 22b's two ranks (:func:`tp_rank_main`) in processes of
    their own; they make their group and mesh, then wait for
    ``tmp/go``."""
    return _rank_procs("--tp-rank", dev, tmp, small)


def tp_ranks_phase(dev, procs: list, tmp: str,
                   small: bool = False) -> dict:
    """22b: two ``gloo`` ranks in processes of their own on the one card
    (NCCL refuses two ranks on one device; :func:`tp_ranks_start`
    started them), a (1, 2) mesh.  Here: the flash kernel against its
    plain version at the rank-local prefill shape of llama3.2-1b (16 q /
    4 KV heads), timed against SDPA; then the ranks are let go and each
    of :data:`TP2_ARCHS` at ``cfg.with_tp(2)`` is served unsharded here,
    fed the ranks' greedy tokens (an MoE arch on rank 0's routes:
    :class:`_RouteLog`), every rank's logits within 5 bf16 ulps at the
    logit scale of the unsharded ones, with flash decode off and on.
    Gloo stages CUDA tensors through the host: these are gloo's times,
    not NCCL's."""
    import torch
    from repro_torch import serve
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    card, on_card = _card_name(), dev.type == "cuda"
    n, out = len(procs), {}
    b, s = (2, 64) if small else (TP_BATCH, TP_PROMPT)
    try:
        # the flash kernel at the TP-local prefill shape of llama3.2-1b
        cfg = _tp_config("llama3.2-1b", small)
        case = ("tp-local", b, cfg.n_heads // n, cfg.n_kv // n, s, s,
                cfg.head_dim_, True, 0, None)
        q, k, v = _flash_inputs(case, torch.bfloat16, dev)
        before = fa.LAUNCHES["flash_attention_wgmma"]
        got = ops.flash_attention(q, k, v, causal=True)
        check(not on_card
              or fa.LAUNCHES["flash_attention_wgmma"] == before + 1,
              "22b: the flash kernel did not launch at the TP-local shape")
        want = fa.flash_attention_plain(q, k, v, causal=True)
        tol = FLASH_TOL["bfloat16"]
        g32, w32 = got.float(), want.float()
        err = float((g32 - w32).abs().max())
        check(bool(((g32 - w32).abs() <= tol + tol * w32.abs()).all()),
              f"22b: flash at {case[1:7]} max|diff| {err!r} beyond {tol}")
        reps = 20 if on_card else 2
        k_ms = _timed(lambda: ops.flash_attention(q, k, v, causal=True),
                      dev, reps)
        p_ms = _timed(lambda: fa.flash_attention_plain(q, k, v,
                                                       causal=True),
                      dev, max(2, reps // 4))
        l_ms = _timed(_sdpa(q, k, v, case), dev, reps)
        bound_ms, bound_by, _, _ = _flash_bound(case, 2)
        out["flash_local"] = {"shape": list(case[1:7]), "max_abs_err": err,
                              "ms": k_ms, "plain_ms": p_ms,
                              "library_ms": l_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by}
        print(f"[{card}] 22b flash kernel at the TP-local prefill shape (B,"
              f" H, Hkv, Sq, Sk, D) = {case[1:7]} bf16 causal: within {tol}"
              f" of its plain version (max_abs_err {err!r}); {k_ms:.4f} ms,"
              f" plain {p_ms:.4f} ms, SDPA {l_ms:.4f} ms, bound"
              f" {bound_ms:.4f} ms ({bound_by})")
        del q, k, v, got, want, g32, w32
        if on_card:
            torch.cuda.empty_cache()

    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    t0 = time.perf_counter()
    _let_ranks_go(procs, tmp, "22b")
    wall = time.perf_counter() - t0
    reports = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
               for r in range(n)]
    scfg = steps.StepConfig()
    for arch in TP2_ARCHS:
        cfg = _tp_config(arch, small).with_tp(n)
        feed = [torch.load(Path(tmp) / f"feed{r}-{arch}.pt")
                for r in range(n)]
        check(all(torch.equal(a, c) for f in feed[1:]
                  for a, c in zip(f, feed[0])),
              f"22b {arch}: the ranks decoded different tokens")
        fed = [t.to(dev) for t in feed[0]]
        model = serve.build_model(cfg, 0, dev, torch.bfloat16)
        prompts = serve.make_prompts(cfg, b, s, 3, dev)
        refs, ties, pre_u, dec_u = {}, [], None, None
        for fd in (0, 1):
            routes = None
            if cfg.moe is not None:  # the reference on rank 0's routes
                routes = _RouteLog(torch.load(
                    Path(tmp) / f"routes0-{arch}-fd{fd}.pt"))
            try:
                refs[fd], _, _, pre, dec, _ = _tp_serve(
                    cfg, scfg, model, prompts, dev, feed=fed, repeat=False)
            finally:
                if routes is not None:
                    routes.close()
            if fd == 0:
                pre_u, dec_u = pre, dec
            if routes is None:
                continue
            check(routes.i == len(routes.forced),
                  f"22b {arch}: {routes.i} router calls against the"
                  f" ranks' {len(routes.forced)}")
            check(routes.max_ulps <= TP_ROUTER_ULPS,
                  f"22b {arch} flash_decode {fd}: the router logits"
                  f" differ from the ranks' by {routes.max_ulps} bf16"
                  f" ulps, beyond {TP_ROUTER_ULPS}")
            ties.append((routes.differ, routes.tokens, routes.max_ulps))
        del model
        if on_card:
            torch.cuda.empty_cache()
        ulp = _bf16_ulp(max(float(x[:, :cfg.vocab].float().abs().max())
                            for x in refs[0]))
        errs = []
        for r in range(n):
            for fd in (0, 1):
                got = torch.load(Path(tmp) / f"logits{r}-{arch}-fd{fd}.pt")
                d = max(float((g[:, :cfg.vocab].float()
                               - w[:, :cfg.vocab].float().cpu())
                              .abs().max()) for g, w in zip(got, refs[fd]))
                errs.append(d)
                check(d <= TP_BF16_ULPS * ulp,
                      f"22b {arch} rank {r} flash_decode {fd}: max|d"
                      f" logit| {d!r} beyond {TP_BF16_ULPS} bf16 ulps"
                      f" ({ulp!r}) of the unsharded path")
                check(not on_card or reports[r][arch][f"fd{fd}"]["flash"]
                      == _gqa_layers(cfg),
                      f"22b {arch} rank {r}: flash launches"
                      f" {reports[r][arch][f'fd{fd}']['flash']}")
        out[arch] = {"unsharded_prefill_ms": pre_u,
                     "unsharded_decode_ms": dec_u,
                     "ranks": [rep[arch] for rep in reports],
                     "max_abs_err": max(errs), "routes": ties}
        for r, rep in enumerate(reports):
            for fd in (0, 1):
                x = rep[arch][f"fd{fd}"]
                print(f"[{card}] 22b {arch} ({cfg.n_layers} layers, bf16,"
                      f" {b} x {s}) rank {r} of a (1, 2) gloo mesh,"
                      f" flash_decode {fd}: prefill {x['prefill_ms']:.3f}"
                      f" ms ({x['prefill_collective_ms']:.3f} ms in"
                      f" collectives), decode {x['decode_ms']:.3f} ms a"
                      f" token ({x['decode_collective_ms']:.3f} ms in"
                      f" collectives); flash launches a prefill"
                      f" {x['flash']}")
        forced = (f"; the unsharded reference on rank 0's routes"
                  f" (flash_decode off, on: tokens routed otherwise, tokens"
                  f" routed, largest router-logit disagreement in bf16"
                  f" ulps {ties})" if ties else "")
        print(f"[{card}] 22b {arch}: every rank's logits within"
              f" {TP_BF16_ULPS} bf16 ulps of the unsharded path's (max |d|"
              f" {max(errs)!r}, ulp {ulp!r}){forced}; unsharded prefill"
              f" {pre_u:.3f} ms, decode {dec_u:.3f} ms a token (one"
              f" pass)")
    out["ranks_wall_s"] = wall
    return out


def tp_times(tree: Path) -> dict:
    """Phase 22 alone: 22b's ranks started, 22a over a one-rank
    ``nccl`` group, then 22b, with the card's name and power limit."""
    import torch
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _card_name()
    t0 = time.perf_counter()
    build.build()
    built = time.perf_counter() - t0
    a, b, walls = tp_phases(torch.device("cuda"))
    return {"tree": str(tree), "card": smi, "build_s": built,
            "22a": a, "22b": b, "walls_s": walls}


def tp_phases(dev, small: bool = False):
    """Phase 22: 22b's ranks started first (their start-up overlaps
    22a), 22a over a one-rank group (``nccl`` on the card), then 22b.
    Returns both phases' results and their walls."""
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = tp_ranks_start(dev, tmp, small)
        try:
            with tempfile.TemporaryDirectory() as tmp1:
                dist.init_process_group(
                    "nccl" if dev.type == "cuda" else "gloo", rank=0,
                    world_size=1,
                    store=dist.FileStore(os.path.join(tmp1, "store"), 1))
                try:
                    a = tp_phase(dev, small)
                finally:
                    dist.destroy_process_group()
        except BaseException:
            for p in procs:
                p.kill()
                p.wait()
            raise
        wall_a = time.perf_counter() - t0
        print(f"[{_card_name()}] phase 22a wall {wall_a:.3f} s")
        t0 = time.perf_counter()
        b = tp_ranks_phase(dev, procs, tmp, small)
        wall_b = time.perf_counter() - t0
        print(f"[{_card_name()}] phase 22b wall {wall_b:.3f} s")
    return a, b, {"22a": wall_a, "22b": wall_b}


# ---------------------------------------------------------------------------
# Phase 23: the tensor-parallel training step
# ---------------------------------------------------------------------------

# 23a on a (1, 1) mesh: (arch, layers or None for all, steps), f32,
# 4 x 1024 tokens a step, 1 MiB buckets.
TP_TRAIN = (("llama3.2-1b", None, 3), ("granite-moe-3b-a800m", 8, 2),
            ("hymba-1.5b", 8, 2))
# 23b on a (1, 2) mesh of two gloo ranks sharing the card.
TP_TRAIN2 = ("llama3.2-1b", 4, 2, 256, 2)  # arch, layers, rows, seq, steps


def _tp_train_config(arch: str, layers, small: bool):
    from repro_torch.configs import get_config, get_smoke_config
    cfg = (get_smoke_config if small else get_config)(arch)
    if layers and not small:
        cfg = cfg.replace(n_layers=layers)
    return cfg.replace(param_dtype="float32")


def _step_grads(state) -> dict:
    return {k: p.grad for k, p in state["params"].named_parameters()}


def tp_train_phase(dev, small: bool = False) -> dict:
    """23a: the tensor-parallel training step over a (1, 1)
    ``DeviceMesh`` on the one-rank group against the unsharded step,
    each of :data:`TP_TRAIN` at full width in f32 from the same seed,
    4 x 1024 tokens a step, partitioned sync with 1 MiB buckets: every
    step's loss and gradients and the parameters after the last step bit
    for bit the unsharded step's, the pack and unpack launches a step
    the plan's multi-leaf buckets on both paths.  Returns per arch the
    step ms of both paths."""
    import numpy as np
    import torch
    from repro_torch.compat import psum_
    from repro_torch.data import pipeline
    from repro_torch.kernels import bucket_pack as bp
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import axis_group, make_mesh
    card, on_card = _card_name(), dev.type == "cuda"
    mesh = make_mesh((1, 1), ("data", "model"), dev)
    psum_(torch.ones(1, device=dev), axis_group(mesh, "model"))  # warm
    batch, seq = (2, 64) if small else (4, 1024)
    out = {}
    for arch, layers, n_steps in TP_TRAIN:
        cfg = _tp_train_config(arch, layers, small)
        stream = pipeline.for_model(cfg, seq, batch)
        data = [steps.batch_to_device(stream.batch(i), dev)
                for i in range(n_steps)]
        scfg = steps.StepConfig(sync_mode="partitioned",
                                aggr_bytes=TRAIN_AGGR, param_dtype="float32",
                                warmup_steps=1, total_steps=10)
        paths = {}
        for name, m in (("unsharded", None), ("tp", mesh)):
            paths[name] = (steps.build_state(cfg, 0, dev, scfg.adam, mesh=m),
                           steps.make_train_step(cfg, scfg, seq_len=seq,
                                                 batch=batch, device=dev,
                                                 mesh=m))
        want_packs = _expected_packs(paths["tp"][0]["params"], "partitioned",
                                     TRAIN_AGGR)
        times = {name: [] for name in paths}
        losses = {name: [] for name in paths}
        for i, b in enumerate(data):
            grads = {}
            for name, (state, step) in paths.items():
                before = dict(bp.LAUNCHES)
                _sync(dev)
                t0 = time.perf_counter()
                state, loss = step(state, b)
                losses[name].append(loss.item())
                _sync(dev)
                times[name].append((time.perf_counter() - t0) * 1e3)
                packs = {k: bp.LAUNCHES[k] - before[k] for k in before}
                check(not on_card or packs == {"bucket_pack": want_packs,
                                               "bucket_unpack": want_packs},
                      f"23a {arch} {name} step {i}: pack/unpack launches"
                      f" {packs}, the plan's {want_packs} each")
                grads[name] = _step_grads(state)
            check(losses["tp"][i] == losses["unsharded"][i],
                  f"23a {arch} step {i}: TP loss {losses['tp'][i]!r} !="
                  f" unsharded {losses['unsharded'][i]!r}")
            check(all(_same_bits(g, grads["tp"][k])
                      for k, g in grads["unsharded"].items()),
                  f"23a {arch} step {i}: TP gradients differ from the"
                  f" unsharded step's")
            del grads
        pt = dict(paths["tp"][0]["params"].named_parameters())
        check(all(_same_bits(p, pt[k]) for k, p in
                  paths["unsharded"][0]["params"].named_parameters()),
              f"23a {arch}: TP parameters differ after {n_steps} steps")
        check(all(np.isfinite(x) for x in losses["tp"]),
              f"23a {arch}: non-finite losses {losses['tp']}")
        del paths, pt
        if on_card:
            torch.cuda.empty_cache()
        out[arch] = {"layers": cfg.n_layers, "losses": losses["tp"],
                     "step_ms": times["tp"],
                     "unsharded_step_ms": times["unsharded"],
                     "packs_a_step": want_packs}
        print(f"[{card}] 23a {arch} ({cfg.n_layers} layers, f32, {batch} x"
              f" {seq} tokens): TP train step on a (1, 1) mesh, {n_steps}"
              f" steps bitwise equal to the unsharded step's (losses"
              f" {losses['tp']}, every gradient, the parameters); pack and"
              f" unpack launches a step {want_packs} each = the plan's;"
              f" step ms {[round(t, 3) for t in times['tp']]} (unsharded"
              f" {[round(t, 3) for t in times['unsharded']]}; host clock,"
              f" the unsharded step first in each pair)")
    return out


def tp_train_rank_main(rank: int, n: int, store: str, out_dir: str,
                       device: str, small: bool) -> None:
    """One of 23b's ranks: a (1, ``n``) mesh over a ``gloo`` group of
    ``n`` processes sharing the card, made at once; when ``out_dir/go``
    appears, :data:`TP_TRAIN2`'s arch at ``cfg.with_tp(n)``: the TP
    step from ``build_state(..., mesh=)``, each step timed with its
    collectives' share, then the unsharded step (synced over the data
    axes, one rank) on the same rows from the same seed; this rank's
    blocks of the step-0 gradients against the unsharded step's
    (``TRAIN_GRAD_TOL``), and the median |g| of each leaf whose partial
    gradients the step sums over ``model``, the scale beside which the
    tolerance's atol stands.  Writes ``train<r>.json``."""
    import torch
    import torch.distributed as dist
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import axis_group, dp_axes, make_mesh
    from repro_torch.models import lm
    from repro_torch.models import tp as tpc
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    dist.init_process_group("gloo", store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    out, report = Path(out_dir), {}
    try:
        mesh = make_mesh((1, n), ("data", "model"), dev)
        timer = _CollectiveTimer(dev)
        t0 = time.perf_counter()
        while not (out / "go").exists():
            if time.perf_counter() - t0 > TP2_TIMEOUT_S:
                raise TimeoutError("23b: the parent never said go")
            time.sleep(0.05)
        arch, layers, rows, seq, n_steps = TP_TRAIN2
        if small:
            rows, seq = 2, 64
        cfg = _tp_train_config(arch, layers, small)
        cfg_tp = cfg.with_tp(n)
        stream = pipeline.for_model(cfg, seq, rows)
        data = [steps.batch_to_device(stream.batch(i), dev)
                for i in range(n_steps)]
        scfg = steps.StepConfig(sync_mode="partitioned",
                                aggr_bytes=TRAIN_AGGR, param_dtype="float32",
                                warmup_steps=1, total_steps=10)
        state = steps.build_state(cfg, 0, dev, scfg.adam, mesh=mesh)
        step = steps.make_train_step(cfg, scfg, seq_len=seq, batch=rows,
                                     device=dev, mesh=mesh)
        losses, ms, coll, g0 = [], [], [], None
        for i, b in enumerate(data):
            _sync(dev)
            timer.clear()
            t0 = time.perf_counter()
            state, loss = step(state, b)
            losses.append(loss.item())
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            coll.append(timer.total())
            if i == 0:
                g0 = {k: g.clone() for k, g in _step_grads(state).items()}
        timer.close()
        del state
        plain = steps.build_state(cfg_tp, 0, dev, scfg.adam)
        ustep = steps.make_train_step(
            cfg_tp, scfg, seq_len=seq, batch=rows, device=dev,
            group=axis_group(mesh, dp_axes(mesh)))
        u_losses, u_ms = [], []
        blocks = lm.param_blocks(cfg_tp, mesh)
        summed = lm.partial_grad_leaves(
            cfg_tp, tpc.from_mesh(mesh, scfg.seq_parallel).splits_seq(seq))
        rtol, atol = TRAIN_GRAD_TOL
        worst, medians = float("-inf"), {}
        for i, b in enumerate(data):
            _sync(dev)
            t0 = time.perf_counter()
            plain, loss = ustep(plain, b)
            u_losses.append(loss.item())
            _sync(dev)
            u_ms.append((time.perf_counter() - t0) * 1e3)
            if i:
                continue
            seen = {}
            for k, g in _step_grads(plain).items():
                parts = k.split(".")
                leaf = ".".join(["layers", *parts[2:]]) \
                    if parts[0] == "layers" else k
                w = g[blocks[leaf][1:] if parts[0] == "layers"
                      else blocks[k]]
                excess = float(((g0[k] - w).abs() - atol - rtol * w.abs())
                               .max())
                worst = max(worst, excess)
                if leaf in summed:
                    seen.setdefault(leaf, []).append(g.abs().flatten())
            medians = {leaf: float(torch.cat(gs).median())
                       for leaf, gs in seen.items()}
        report = {"losses": losses, "unsharded_losses": u_losses,
                  "step_ms": ms, "collective_ms": coll,
                  "unsharded_step_ms": u_ms, "grad_excess": worst,
                  "summed_median_abs_grad": medians,
                  "layers": cfg.n_layers, "rows": rows, "seq": seq}
    finally:
        (out / f"train{rank}.json").write_text(json.dumps(report))
        dist.destroy_process_group()


def _rank_procs(flag: str, dev, tmp: str, small: bool) -> list:
    """Two ranks of ``chip_smoke.py flag`` in processes of their own
    (22b's and 23b's); they make their group and mesh, then wait for
    ``tmp/go``."""
    return [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), flag,
         str(r), "2", os.path.join(tmp, "store"), tmp, dev.type,
         "small" if small else "full"],
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]


def _let_ranks_go(procs: list, tmp: str, what: str) -> list:
    """Say go to the ranks, wait for them (killing any left), require
    exit code 0 and return their logs."""
    logs = []
    try:
        (Path(tmp) / "go").write_text("")
        logs = [p.communicate(timeout=TP2_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        check(p.returncode == 0, f"{what}: a rank failed:\n{log[-3000:]}")
    return logs


def tp_train_ranks_phase(dev, procs: list, tmp: str,
                         small: bool = False) -> dict:
    """23b: two ``gloo`` ranks in processes of their own on the one card
    (:func:`tp_train_rank_main`), a (1, 2) mesh: every rank's losses and
    step-0 gradient blocks within ``TRAIN_GRAD_TOL`` of the unsharded
    step on the card, its step and collective ms printed.  Gloo stages
    CUDA tensors through the host: these are gloo's times, not NCCL's."""
    card = _card_name()
    t0 = time.perf_counter()
    _let_ranks_go(procs, tmp, "23b")
    wall = time.perf_counter() - t0
    reports = [json.loads((Path(tmp) / f"train{r}.json").read_text())
               for r in range(len(procs))]
    arch = TP_TRAIN2[0]
    for r, rep in enumerate(reports):
        check(rep["losses"] == reports[0]["losses"],
              f"23b rank {r}: losses {rep['losses']} != rank 0's")
        check(all(abs(a - b) <= TRAIN_LOSS_RTOL * abs(b) for a, b in
                  zip(rep["losses"], rep["unsharded_losses"])),
              f"23b rank {r}: losses {rep['losses']} against the unsharded"
              f" {rep['unsharded_losses']}")
        check(rep["grad_excess"] <= 0.0,
              f"23b rank {r}: a step-0 gradient beyond {TRAIN_GRAD_TOL}"
              f" of the unsharded step's by {rep['grad_excess']!r}")
        print(f"[{card}] 23b {arch} ({rep['layers']} layers, f32,"
              f" {rep['rows']} x {rep['seq']} tokens) at with_tp(2), rank"
              f" {r} of a (1, 2) gloo mesh: losses {rep['losses']}"
              f" (unsharded {rep['unsharded_losses']}, rtol"
              f" {TRAIN_LOSS_RTOL}), step-0 gradient blocks within"
              f" {TRAIN_GRAD_TOL} (rtol, atol) of the unsharded step's,"
              f" worst excess {rep['grad_excess']!r}; median |g| of the"
              f" leaves summed over 'model'"
              f" {rep['summed_median_abs_grad']}; step ms"
              f" {[round(x, 3) for x in rep['step_ms']]}, of it in"
              f" collectives {[round(x, 3) for x in rep['collective_ms']]};"
              f" unsharded step ms"
              f" {[round(x, 3) for x in rep['unsharded_step_ms']]}")
    return {"ranks": reports, "ranks_wall_s": wall}


def tp_train_phases(dev, small: bool = False):
    """Phase 23: 23b's ranks started first (their start-up overlaps
    23a), 23a over a one-rank group (``nccl`` on the card), then 23b.
    Returns both phases' results and their walls."""
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = _rank_procs("--tp-train-rank", dev, tmp, small)
        try:
            with tempfile.TemporaryDirectory() as tmp1:
                dist.init_process_group(
                    "nccl" if dev.type == "cuda" else "gloo", rank=0,
                    world_size=1,
                    store=dist.FileStore(os.path.join(tmp1, "store"), 1))
                try:
                    a = tp_train_phase(dev, small)
                finally:
                    dist.destroy_process_group()
        except BaseException:
            for p in procs:
                p.kill()
                p.wait()
            raise
        wall_a = time.perf_counter() - t0
        print(f"[{_card_name()}] phase 23a wall {wall_a:.3f} s")
        t0 = time.perf_counter()
        b = tp_train_ranks_phase(dev, procs, tmp, small)
        wall_b = time.perf_counter() - t0
        print(f"[{_card_name()}] phase 23b wall {wall_b:.3f} s")
    return a, b, {"23a": wall_a, "23b": wall_b}


def tp_train_times(tree: Path) -> dict:
    """Phase 23 alone (its kernels built first), with the card's name and
    power limit."""
    import torch
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _card_name()
    t0 = time.perf_counter()
    build.build()
    built = time.perf_counter() - t0
    a, b, walls = tp_train_phases(torch.device("cuda"))
    return {"tree": str(tree), "card": smi, "build_s": built,
            "23a": a, "23b": b, "walls_s": walls}


# ---------------------------------------------------------------------------
# Phase 24: the dry run and the roofline rows
# ---------------------------------------------------------------------------

# 24a: production cells of the dry run on the fake 16x16 group.
DRYRUN_CELLS = (("llama3.2-1b", "train_4k"), ("llama3.2-1b", "decode_32k"))
# 24b on a (1, 1) mesh, llama3.2-1b at full depth: (kind, parameter
# dtype, rows, sequence): phase 13's train cell and phase 9's prefill.
DRYRUN_CHECKS = (("train", "float32", 4, 1024),
                 ("prefill", "bfloat16", 4, 1024))
# the measured peak (torch.cuda.max_memory_allocated over the step)
# within this share of the dry run's predicted peak
DRYRUN_MEM_RTOL = 0.10
DRYRUN_TIMEOUT_S = 300


def _dryrun_checks(small: bool) -> list:
    """24b's (ShapeConfig, StepConfig) pairs (2 x 64 tokens when
    ``small``)."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch.steps import StepConfig
    out = []
    for kind, dtype, rows, seq in DRYRUN_CHECKS:
        if small:
            rows, seq = 2, 64
        out.append((ShapeConfig(f"check_{kind}", kind, seq, rows),
                    StepConfig(param_dtype=dtype, aggr_bytes=TRAIN_AGGR)))
    return out


def _dryrun_config(small: bool):
    from repro_torch.configs import get_config, get_smoke_config
    return (get_smoke_config if small else get_config)("llama3.2-1b")


def dryrun_trace_main(out_dir: str, small: bool) -> None:
    """Phase 24's dry run, in a process of its own (its default group is
    the fake group of 256 ranks): 24a's production cells on the 16x16
    mesh (the decode cell alone when ``small``), written as the CLI
    writes them under ``out_dir/art``, and 24b's cells on a (1, 1)
    mesh; every record in ``out_dir/dryrun.json``."""
    from repro_torch.launch import dryrun
    dryrun.fake_world(256)
    art = Path(out_dir) / "art"
    art.mkdir()
    recs = {"24a": [], "24b": []}
    for arch, shape in DRYRUN_CELLS:
        if small and shape == "train_4k":
            continue
        rec = dryrun.analyze_cell(arch, shape)
        (art / f"{arch}__{shape}__single.json").write_text(json.dumps(rec))
        recs["24a"].append(rec)
    for shape, scfg in _dryrun_checks(small):
        recs["24b"].append(dryrun.analyze_cell(
            "llama3.2-1b", shape, mesh_shape=(1, 1), scfg=scfg,
            cfg=_dryrun_config(small)))
    (Path(out_dir) / "dryrun.json").write_text(json.dumps(recs))


def _fill_args(cfg, parts, dev, seed: int = 0) -> None:
    """Values for the empty tensors of ``dryrun.cell_call``: weights
    normal(0, 0.02), tokens and labels in the vocabulary; the cache and
    the moments stay zero."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for p in parts["params"].parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=dev) * 0.02)
        for t in parts["batch"].values():
            if t.dtype == torch.int32:
                t.copy_(torch.randint(0, cfg.vocab, t.shape, generator=g,
                                      device=dev))
            else:
                t.copy_(torch.randn(t.shape, generator=g, device=dev))


def _dryrun_real(dev, small: bool) -> list:
    """24b's steps for real over a (1, 1) mesh of the one-rank group:
    the arguments of ``dryrun.cell_call`` on the card, filled; the first
    call under ``FlopCounterMode`` with the ``compat.CALLS`` deltas, its
    argument bytes and its peak above what was allocated before; then
    the event-timed ms of a second call."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import compat
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    on_card = dev.type == "cuda"
    mesh = make_mesh((1, 1), ("data", "model"), dev.type)
    cfg = _dryrun_config(small)
    out = []
    for shape, scfg in _dryrun_checks(small):
        _sync(dev)
        base = torch.cuda.memory_allocated(dev) if on_card else 0
        step, args, kw, parts = dryrun.cell_call(
            "llama3.2-1b", shape, mesh, scfg, dev, cfg)
        _fill_args(cfg, parts, dev)
        _sync(dev)
        rec = {"argument_bytes": (torch.cuda.memory_allocated(dev) - base
                                  if on_card else None)}
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        before = dict(compat.CALLS)
        with FlopCounterMode(display=False) as fc:
            res = step(*args, **kw)
        _sync(dev)
        rec["peak_bytes"] = (torch.cuda.max_memory_allocated(dev) - base
                             if on_card else None)
        rec["calls"] = {k: compat.CALLS[k] - before[k] for k in before}
        rec["flops"] = fc.get_total_flops()
        del res
        rec["ms"] = _timed(lambda: step(*args, **kw), dev, 1, warmup=0)
        out.append(rec)
        del step, args, kw, parts
        if on_card:
            torch.cuda.empty_cache()
    return out


def dryrun_phase(dev, small: bool = False) -> dict:
    """Phase 24 (a one-rank group initialised by the caller): the dry
    run of :func:`dryrun_trace_main` in a subprocess while 24b's steps
    run here for real; 24a's records printed with their roofline rows
    (``benchmarks.roofline_report``); 24b's real FLOPs
    (``FlopCounterMode``) and ``compat.CALLS`` counts and bytes by type
    equal to the dry run's exactly, the measured peak within
    ``DRYRUN_MEM_RTOL`` of the predicted one, and each step's time over
    its roofline's largest term printed."""
    from repro_torch.benchmarks import roofline_report
    card = _card_name()
    on_card = dev.type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--dryrun-trace",
             tmp, "small" if small else "full"],
            env={**os.environ, "PYTHONPATH": os.pathsep.join(
                [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            real = _dryrun_real(dev, small)
            log = proc.communicate(timeout=DRYRUN_TIMEOUT_S)[0]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        check(proc.returncode == 0, f"24: the dry run failed:\n{log[-3000:]}")
        wall_dry = time.perf_counter() - t0
        recs = json.loads((Path(tmp) / "dryrun.json").read_text())
        rows = roofline_report.rows(art=Path(tmp) / "art")
    for rec in recs["24a"]:
        r, m, c = rec["roofline"], rec["memory"], rec["collectives"]
        print(f"[{card}] 24a dry run {rec['arch']} x {rec['shape']} x"
              f" {rec['mesh']} (fake {rec['trace_device']} tensors, rank 0"
              f" of {rec['n_chips']}): trace {rec['trace_s']} s,"
              f" {rec['n_ops']} ops; compute {r['compute_s']!r} s, memory"
              f" {r['memory_s']!r} s, collective {r['collective_s']!r} s,"
              f" dominant {r['dominant']}, useful compute"
              f" {r['useful_compute_ratio']!r}; {m['total_per_device_gib']}"
              f" GiB a GPU (fits 80 GB: {m['fits_80gb']}); collectives"
              f" {c['counts']} of {c['bytes']} bytes")
    for name, us, derived in rows:
        print(f"[{card}] 24a {name},{us:.3f},{derived}")
    kinds = {"all_reduce": "all-reduce", "all_gather": "all-gather",
             "reduce_scatter": "reduce-scatter",
             "ppermute": "collective-permute"}
    for (shape, scfg), rec, got in zip(_dryrun_checks(small), recs["24b"],
                                       real):
        what = (f"24b llama3.2-1b {shape.kind} ({scfg.param_dtype},"
                f" {shape.global_batch} x {shape.seq_len} tokens, (1, 1)"
                f" mesh)")
        flops = rec["cost"]["flops_per_device"]
        check(got["flops"] == flops,
              f"{what}: FlopCounterMode {got['flops']} != the dry run's"
              f" {flops!r}")
        counts, nbytes = (rec["collectives"]["counts"],
                          rec["collectives"]["bytes"])
        for call, k in kinds.items():
            check(got["calls"][call] == counts.get(k, 0)
                  and got["calls"][f"{call}_bytes"] == nbytes.get(k, 0),
                  f"{what}: {call} {got['calls'][call]} calls of"
                  f" {got['calls'][f'{call}_bytes']} bytes, the dry run"
                  f" {counts.get(k, 0)} of {nbytes.get(k, 0)}")
        want_peak = rec["memory"]["total_per_device_bytes"]
        share = None
        if on_card:
            share = got["peak_bytes"] / want_peak
            check(abs(share - 1) <= DRYRUN_MEM_RTOL,
                  f"{what}: peak {got['peak_bytes']} B, the dry run"
                  f" predicts {want_peak} B ({share:.3f})")
        r = rec["roofline"]
        big = max(r["compute_s"], r["memory_s"], r["collective_s"])
        print(f"[{card}] {what}: FLOPs {got['flops']} = the dry run's,"
              f" collectives {counts} of {nbytes} bytes = compat.CALLS';"
              f" arguments {got['argument_bytes']} B (dry run"
              f" {rec['memory']['argument_bytes']}), peak"
              f" {got['peak_bytes']} B against the predicted {want_peak} B"
              f" (measured / predicted {share!r}, tolerance"
              f" {DRYRUN_MEM_RTOL}); step {got['ms']:.3f} ms, roofline"
              f" {r['dominant']} {big * 1e3:.4f} ms (compute"
              f" {r['compute_s'] * 1e3:.4f}, memory"
              f" {r['memory_s'] * 1e3:.4f}, collective"
              f" {r['collective_s'] * 1e3:.4f} ms): measured / largest term"
              f" {got['ms'] / (big * 1e3):.2f}; traced in"
              f" {rec['trace_s']} s")
    print(f"[{card}] 24 the dry run's subprocess and 24b's steps:"
          f" {wall_dry:.3f} s")
    return {"24a": recs["24a"], "24b": recs["24b"], "real": real}


def dryrun_times(tree: Path) -> dict:
    """Phase 24 alone (its kernels built first) over a one-rank
    ``nccl`` group, with the card's name and power limit."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _card_name()
    t0 = time.perf_counter()
    build.build()
    built = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", rank=0, world_size=1,
            store=dist.FileStore(os.path.join(tmp, "store"), 1))
        try:
            t0 = time.perf_counter()
            out = dryrun_phase(torch.device("cuda"))
            wall = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    return {"tree": str(tree), "card": smi, "build_s": built, "wall_s": wall,
            "24b_real": out["real"]}


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
        print(f"card: {_card_name()}")
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

    # 16. the planner and the CommPlan IR -----------------------------------
    t0 = time.perf_counter()
    planner_phase(dev, baseline)
    print(f"phase 16 wall {time.perf_counter() - t0:.3f} s")

    # 17. the families and the stub frontends on the serving path -------
    t0 = time.perf_counter()
    family_phase(dev, small)
    print(f"phase 17 wall {time.perf_counter() - t0:.3f} s")

    # 18. every family trained at full width --------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if on_card else "gloo", rank=0, world_size=1,
            store=dist.FileStore(os.path.join(tmp, "store"), 1))
        try:
            train_family_phase(dev, small)
        finally:
            dist.destroy_process_group()
    print(f"phase 18 wall {time.perf_counter() - t0:.3f} s")

    # 19. partitioned communication on torch.distributed -----------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if on_card else "gloo", rank=0, world_size=1,
            store=dist.FileStore(os.path.join(tmp, "store"), 1))
        try:
            partitioned_phase(dev, small)
        finally:
            dist.destroy_process_group()
    print(f"[{_card_name()}] phase 19 wall {time.perf_counter() - t0:.3f} s")

    # 20. the evaluation tooling ------------------------------------------
    t0 = time.perf_counter()
    tooling_phase(dev, baseline, small)
    print(f"[{_card_name()}] phase 20 wall {time.perf_counter() - t0:.3f} s")

    # 21. the float32 mode and the mesh layer -----------------------------
    t0 = time.perf_counter()
    fabric_f32 = f32_phase(dev, baseline)
    print(f"[{_card_name()}] phase 21a wall {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if on_card else "gloo", rank=0, world_size=1,
            store=dist.FileStore(os.path.join(tmp, "store"), 1))
        try:
            mesh_phase(dev, train["modes"]["partitioned"]["losses"], small)
        finally:
            dist.destroy_process_group()
    print(f"[{_card_name()}] phase 21b wall {time.perf_counter() - t0:.3f} s")

    # 22. the tensor- and expert-parallel serving forward -----------------
    tp_phases(dev, small)

    # 23. the tensor-parallel training step -------------------------------
    tp_train_phases(dev, small)

    # 24. the dry run and the roofline rows --------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if on_card else "gloo", rank=0, world_size=1,
            store=dist.FileStore(os.path.join(tmp, "store"), 1))
        try:
            dryrun_phase(dev, small)
        finally:
            dist.destroy_process_group()
    print(f"[{_card_name()}] phase 24 wall {time.perf_counter() - t0:.3f} s")
    return {"kernels": [fabric, fabric_f32, *flash, *train_kernels]}


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


def trace_attribution(tree: Path) -> dict:
    """How ``_device_profile`` tells the measured calls' device events
    from the rest of a trace, tried on the pack kernels of the source
    tree ``tree``: 60 ``_trace_groups`` traces each of 10 pack and of 10
    unpack calls at the bulk and the [ln1, ln2] buckets.  For each case
    the counts of traces by the kernels they hold, by those whose traced
    start lies in the measured range and by those whose launch does, and
    the least and greatest traced start of a kernel less its launch's
    (us, on the trace's clock)."""
    import torch
    from repro_torch.kernels import ops
    cuda = torch.autograd.DeviceType.CUDA
    dev = torch.device("cuda")
    out = {"tree": str(tree), "card": _card_name(),
           "torch": torch.__version__, "cuda": torch.version.cuda}
    for name, segs in zip(("bulk", "ln1_ln2"), _bulk_bucket(dev, False)):
        flat = ops.bucket_pack(segs)
        for what, fn in (
                ("pack", lambda: ops.bucket_pack(segs)),
                ("unpack", lambda: ops.bucket_unpack(flat, segs, out=segs))):
            hist = {"traced": {}, "by_start": {}, "by_launch": {}}
            offs = []
            for _ in range(60):
                events, span, issued = _trace_groups(fn, 10)
                launch = {e.id: e.time_range.start for e in events
                          if e.device_type != cuda
                          and e.name.startswith("cu")}
                kern = [e for e in events if e.device_type == cuda
                        and "bucket_kernel" in e.name]
                for key, k in (
                        ("traced", len(kern)),
                        ("by_start", sum(span.start <= e.time_range.start
                                         <= span.end for e in kern)),
                        ("by_launch", sum(e.id in issued for e in kern))):
                    hist[key][k] = hist[key].get(k, 0) + 1
                offs += [e.time_range.start - launch[e.id] for e in kern
                         if e.id in launch]
            out[f"{what} {name}"] = {
                **{k: dict(sorted(v.items())) for k, v in hist.items()},
                "start_less_launch_us": [min(offs), max(offs)] if offs
                else None}
    return out


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


def families_times(tree: Path) -> dict:
    """Phase 17 on the port of the source tree ``tree``: each family's
    median prefill ms, decode ms a token and peak memory, with the
    card's name and power limit."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _card_name()
    out = family_phase(torch.device("cuda"))
    return {"tree": str(tree), "card": smi,
            "families": {arch: {k: v for k, v in rec.items()
                                if k != "launches"}
                         for arch, rec in out.items()
                         if arch in FAMILY_ARCHS}}


def train_families_times(tree: Path) -> dict:
    """Phase 18 on the port of the source tree ``tree``: each family's
    layers, step ms, tokens/s, peak memory, device idle share and
    pack/unpack device ms, the depth cuts, and the card's name and power
    limit."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _card_name()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", rank=0, world_size=1,
            store=dist.FileStore(os.path.join(tmp, "store"), 1))
        try:
            out = train_family_phase(torch.device("cuda"))
        finally:
            dist.destroy_process_group()
    keys = ("layers", "step_ms", "tokens_per_s", "peak_gib", "wall_s")
    return {"tree": str(tree), "card": smi, "cuts": out["cuts"],
            "families": {arch: {**{k: rec[k] for k in keys},
                                "profile": rec["modes"]["partitioned"]
                                .get("profile")}
                         for arch, rec in out.items() if arch != "cuts"}}


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
    ranks = {"--tp-rank": tp_rank_main,  # one of 22b's ranks
             "--tp-train-rank": tp_train_rank_main}  # one of 23b's
    if argv[:1] and argv[0] in ranks and len(argv) == 7:
        sys.path.insert(0, str(ROOT / "src"))
        ranks[argv[0]](int(argv[1]), int(argv[2]), argv[3], argv[4],
                       argv[5], argv[6] == "small")
        return 0
    if argv[:1] == ["--dryrun-trace"] and len(argv) == 3:  # phase 24's
        sys.path.insert(0, str(ROOT / "src"))
        dryrun_trace_main(argv[1], argv[2] == "small")
        return 0
    if not _card_ready():
        return 1
    import torch
    tree = ROOT
    times = {"--fabric-times": fabric_times, "--quant8-times": quant8_times,
             "--families": families_times,
             "--train-families": train_families_times,
             "--trace-attribution": trace_attribution, "--tp": tp_times,
             "--tp-train": tp_train_times, "--dryrun": dryrun_times}
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
