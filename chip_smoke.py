#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` and
drives the port's stencil main path on the card, phase by phase; every
phase prints one line and any failure exits non-zero without a result:

  1. the card (``nvidia-smi`` name and power limit) and the kernel build;
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
     with its host assembly; then the kernel table as one JSON line.

The last line is ``{"ok": true, "device": {...}}``.  The script imports
nothing of the JAX package; it reads the baseline as data.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BASELINE = ROOT / "BENCH_scenarios.json"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and fp64 vector rate.
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12


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


def run(device_name: str = "cuda") -> dict:
    """All phases on ``device_name``; returns the kernel table."""
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
        regs = [ln.strip() for ln in
                build.log_path("fabric_scan").read_text().splitlines()
                if "registers" in ln]
        print(f"build: {', '.join(p.name for p in paths.values())} in"
              f" {time.perf_counter() - t0:.3f} s; ptxas: {' | '.join(regs)}")

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
    return {"kernels": [{
        "name": "fabric_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/fabric_scan.cu",
        "replaces": "src/repro/core/fabric_pallas.py:434",
        "launches": launches, "max_abs_err": max(errs), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}


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
