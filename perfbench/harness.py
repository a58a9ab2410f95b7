"""One run of one cell: find its files by name, check the card, run it,
print the result line.

``main`` reads ``BENCHMARK.json`` at the root of the checkout, takes the
cell ``--workload``, its configuration file, its traffic mix
(``traffic/<traffic>.json``), its limits (``limits/<workload>.json``)
and the readers of the per-layer metrics that list it
(``metrics/<metric>.py``), and runs the cell's kind (``cells.py``).
With ``--trace 0`` the result's metrics are the cell's end-to-end
metrics; with ``--trace 1`` the same window is followed by
``trace_steps`` or ``trace_batches`` of the mix under
``torch.profiler``, and the metrics are the per-layer ones of the
per-layer entries that list the cell.  The numbers compared with the plain reference are
printed beside their limits as the last lines on standard error and
under ``check``, the result's last key.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
import time
from typing import Dict, List, Optional

from .sizes import ROOT, sizes
from .traffic.gen import load_mix

CHECKOUT = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole (``repro_torch`` is not
    ``repro``)."""
    mods = sys.modules if modules is None else modules
    return sorted({m for m in mods if m.split(".")[0] in FORBIDDEN})


def load_reader(name: str):
    """The ``read(run)`` of ``metrics/<name>.py``."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_spec(bench: dict, workload: str) -> dict:
    """Everything the cell ``workload`` of ``bench`` is made of."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; one of"
                         f" {sorted(cells)}")
    cell = cells[workload]
    conf_entry = next(c for c in bench["configs"]
                      if c["name"] == cell["config"])
    conf = json.loads((CHECKOUT / conf_entry["file"]).read_text())
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    layer = [m for m in bench["per_layer"] if workload in m["workloads"]]
    return {"cell": cell, "conf": conf, "mix": load_mix(cell["traffic"]),
            "limits": json.loads((ROOT / "limits" / f"{workload}.json")
                                 .read_text()),
            "end_to_end": e2e, "per_layer": layer}


def check(numbers: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """Each number the cell's limits list, beside its limit."""
    return {k: {"value": numbers[k], "limit": lim["limit"]}
            for k, lim in limits["numbers"].items()}


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them: the
    peaks of ``yardstick.PEAK`` assume the full 700 W."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, **hooks):
    from . import cells
    kind = spec["mix"]["kind"]
    run = {"train": cells.run_train,
           "prefill_closed_loop": cells.run_prefill}[kind]
    return run(sizes(spec["conf"]), spec["mix"], seed, seconds, trace,
               device, t_start, **hooks)


def result(spec: dict, run, trace: bool, device_info: dict) -> dict:
    """The result line of a finished run."""
    checked = check(run.numbers, spec["limits"])
    correct = (run.failed == 0 and run.attempted > 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checked.values()))
    metrics: Dict[str, dict] = {}
    if trace:
        for m in spec["per_layer"]:
            v = load_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info = {**device_info, "busy_s": run.trace.busy_s,
                       "window_s": run.trace.window_s}
    else:
        for m in spec["end_to_end"]:
            if m["name"] == "setup_s":
                v = run.setup["setup_s"]
            elif m["name"] == "peak_mem_gib":
                v = run.memory_peak_bytes / 2 ** 30
            else:
                v = run.end_to_end[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics,
           "device": {**device_info,
                      "memory_peak_bytes": run.memory_peak_bytes}}
    if trace:
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["check"] = checked
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python3 perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    spec = cell_spec(bench, args.workload)

    import torch
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s);"
              f" torch.cuda.is_available() is"
              f" {torch.cuda.is_available()}, device_count"
              f" {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    tf32 = bool(spec["mix"]["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.zeros(1, device=device)
    import_s = time.perf_counter() - t_start

    run = run_cell(spec, args.seed, args.seconds, bool(args.trace), device,
                   t_start)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips}
    split = {"import_and_cuda_init_s": import_s, **run.setup}
    print("card: " + card_line())
    print("setup: " + json.dumps(split))
    print("counters: " + json.dumps({**run.counters,
                                      "window_s": run.window_s,
                                      "units": len(run.units)}))
    print("notes: " + json.dumps({**run.notes, "numbers": run.numbers}))
    out = result(spec, run, bool(args.trace), info)
    for k, c in out["check"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
