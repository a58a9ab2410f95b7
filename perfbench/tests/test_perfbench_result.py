"""The result line's shape, the trace reading, and the no-JAX check."""

import ast
import json
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from perfbench import harness
from perfbench.cells import Run
from perfbench.tests import smoke
from perfbench.trace import WINDOW, Trace

PERFBENCH = Path(harness.__file__).resolve().parent


def _ev(name, a, b, cuda=False):
    dt = torch.autograd.DeviceType
    return types.SimpleNamespace(
        name=name, device_type=dt.CUDA if cuda else dt.CPU,
        time_range=types.SimpleNamespace(start=a, end=b))


def _trace():
    prof = types.SimpleNamespace(events=lambda: [
        _ev(WINDOW, 0, 100), _ev("perfbench.step", 0, 100),
        _ev("aten::mm", 5, 30), _ev("cudaStreamSynchronize", 75, 99),
        _ev("gemm", 10, 40, True), _ev("nccl", 20, 50, True),
        _ev("gemm", 70, 80, True), _ev("late", 95, 120, True)])
    return Trace(prof)


def test_trace_union_gaps_and_ops():
    t = _trace()
    assert t.window_s == 100e-6
    assert abs(t.busy_s - (40 + 10 + 5) * 1e-6) < 1e-15   # union, clipped
    assert t.launches(lambda n: n == "gemm") == 2
    assert abs(t.device_time_s(lambda n: n == "gemm") - 40e-6) < 1e-15
    ops = dict(t.device_ops())
    assert set(ops) == {"gemm", "nccl", "late"}
    gaps = dict(t.idle_gaps())
    # gaps [0,10) [50,70) [80,95): by the innermost host op at the middle
    assert abs(gaps["aten::mm"] - 10e-6) < 1e-15
    assert abs(gaps["perfbench.step"] - 20e-6) < 1e-15
    assert abs(gaps["cudaStreamSynchronize"] - 15e-6) < 1e-15


def _spec():
    return smoke.spec("granite-moe.train", smoke.granite(), smoke.train_mix())


def _fake_run(spec):
    from perfbench.sizes import sizes
    run = Run(sizes(spec["conf"]), spec["mix"], torch.device("cpu"))
    run.units = [{"batch": 2, "seq_len": 64}] * 3
    run.window_s, run.attempted = 1.5, 3
    run.end_to_end = {"train_tokens_per_s": 384.0}
    run.setup = {"setup_s": 12.5}
    run.memory_peak_bytes = 3 << 30
    run.counters = {"sync_allreduces_per_step": 7}
    run.numbers = {"loss_gap": 1e-7, "grad1_median_gap": 2e-6,
                   "change_gap": 1e-6, "grad1_slice_q10": 1e-6}
    return run


def test_result_line_untraced():
    spec = _spec()
    out = harness.result(spec, _fake_run(spec), False,
                         {"platform": "gpu", "kind": "x", "count": 1})
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "check" and out["correct"] is True
    assert set(out["metrics"]) == {"train_tokens_per_s", "peak_mem_gib",
                                   "setup_s"}
    assert out["metrics"]["peak_mem_gib"] == {"value": 3.0, "unit": "GiB"}
    assert out["device"]["memory_peak_bytes"] == 3 << 30
    assert set(out["check"]["loss_gap"]) == {"value", "limit"}
    json.dumps(out)


def test_result_line_traced_and_incorrect():
    spec = _spec()
    run = _fake_run(spec)
    run.trace = _trace()
    run.numbers["loss_gap"] = 1.0
    out = harness.result(spec, run, True,
                         {"platform": "gpu", "kind": "x", "count": 1})
    assert out["correct"] is False
    assert set(out["metrics"]) == {"mfu.train",
                                   "sync_allreduces_per_step.train",
                                   "idle_share.train"}   # pack reads none
    assert out["device"]["busy_s"] == run.trace.busy_s
    assert out["device"]["window_s"] == run.trace.window_s
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(out["breakdown"]["device_ops"]) <= 10
    assert list(out)[-1] == "check"


def test_every_cell_finds_its_files():
    bench = json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        spec = harness.cell_spec(bench, w["name"])
        assert set(spec["limits"]["numbers"])
        assert spec["end_to_end"] and spec["per_layer"]
        for m in spec["per_layer"]:
            assert callable(harness.load_reader(m["name"]))


def test_a_per_layer_metric_reads_only_in_the_cells_it_lists():
    bench = json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        spec = harness.cell_spec(bench, w["name"])
        assert {m["name"] for m in spec["per_layer"]} == {
            m["name"] for m in bench["per_layer"]
            if w["name"] in m["workloads"]}
    bench["per_layer"].append({"name": "x", "moves": "setup_s"})
    with pytest.raises(KeyError):
        harness.cell_spec(bench, bench["workloads"][0]["name"])


def test_forbidden_names_are_whole_top_level_names():
    mods = {"repro_torch": 1, "repro_torch.models": 1, "reprox": 1,
            "jaxtyping": 1, "jax.numpy": 1, "repro.core": 1, "flax": 1}
    assert harness.forbidden_modules(mods) == ["flax", "jax.numpy",
                                               "repro.core"]


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path[:0] = ['.', 'src'];"
            " import perfbench.harness as h, perfbench.cells,"
            " perfbench.calibrate, perfbench.reference.model,"
            " perfbench.reference.granite_moe, perfbench.reference.mamba2,"
            " perfbench.families.granite_moe, perfbench.families.mamba2;"
            " import repro_torch.launch.steps;"
            " print(h.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.CHECKOUT, check=True)
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_port():
    for path in (PERFBENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = ["." * node.level + (node.module or "")]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("repro_torch", "repro", "jax", "perfbench"), \
                    (path.name, n)
                # the reference's own modules, and the benchmark's leaf
                # list for which layers a leaf covers
                assert not n.startswith(".") or n in (
                    ".common", ".granite_moe", ".mamba2", ".",
                    "..weights"), (path.name, n)


def test_named_spans_mirrored_on_the_device_are_not_work():
    ann = _ev("perfbench.step", 0, 100, True)
    user = _ev("my range", 0, 100, True)
    user.is_user_annotation = True
    prof = types.SimpleNamespace(events=lambda: [
        _ev(WINDOW, 0, 100), ann, user, _ev("gemm", 10, 20, True)])
    t = Trace(prof)
    assert abs(t.busy_s - 10e-6) < 1e-15
    assert [n for n, _ in t.device_ops()] == ["gemm"]
