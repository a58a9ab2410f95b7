"""The per-layer metrics read from the port's own spans and counters
(``perfbench/spans.py`` and its readers): the right share from a
synthetic trace and a stubbed snapshot, nothing from a trace without
spans, device events or a pairing of launches, from a run that traced
nothing or from a port without telemetry, and a drop share from a
smoke-size traced CPU run."""

import sys
import types

import pytest
import torch

from perfbench import harness, spans
from perfbench.tests import smoke
from repro_torch import telemetry

SEED = 2 ** 31 + 4242

DEVICE_SHARES = ("moe_share.train", "moe_share.prefill", "ssd_share.prefill",
                 "optim_share.train")
DROP_SHARES = ("moe_drop_share.train", "moe_drop_share.prefill")

# host spans (us): a train step, then a prefill
SPANS = [(0, 100, "repro.train_step"), (0, 40, "repro.forward"),
         (5, 30, "repro.moe"), (10, 20, "repro.moe.experts"),
         (35, 38, "repro.moe_other"), (40, 80, "repro.backward"),
         (45, 75, "repro.moe.bwd"), (50, 70, "repro.moe.combine.bwd"),
         (55, 60, "repro.attn.recompute"), (80, 100, "repro.optim"),
         (200, 300, "repro.prefill"), (210, 260, "repro.mamba"),
         (220, 240, "repro.ssd"), (260, 280, "repro.moe")]
# (launch, device start, device end): the device runs behind the host
WORK = [(2, 200, 210), (6, 210, 215), (12, 215, 235), (36, 235, 240),
        (46, 240, 250), (52, 250, 256), (56, 256, 266), (82, 270, 274),
        (205, 400, 410), (225, 410, 430), (250, 430, 435), (265, 440, 450)]
WANT = {"moe_share.train": 100 * (5 + 20 + 10 + 6) / 70,
        "moe_share.prefill": 100 * 10 / 45,
        "ssd_share.prefill": 100 * 20 / 45,
        "optim_share.train": 100 * 4 / 70,
        "moe_drop_share.train": 100 * 6 / 400,
        "moe_drop_share.prefill": 100 * 6 / 400}


@pytest.fixture(autouse=True)
def fresh():
    telemetry.reset()
    yield
    telemetry.reset()


def _trace(spans=SPANS, work=WORK, api="cudaLaunchKernel"):
    host = [(t, t + 1.0, api) for t, _, _ in work] + list(spans) + [
        (1, 3, "aten::mm")]
    return types.SimpleNamespace(
        _host=sorted(host),
        kernels=[(a, b, f"k{i}") for i, (_, a, b) in enumerate(work)])


def _run(traced=True, trace=None):
    return types.SimpleNamespace(
        traced_units=[{"batch": 1}] if traced else [],
        trace=_trace() if trace is None else trace)


def _stub(monkeypatch, snap):
    monkeypatch.setattr(telemetry, "snapshot", lambda: snap)


SNAP = {"spans": {"repro.moe": {"calls": 1, "host_s": 1.0,
                                "host_self_s": 1.0}},
        "counters": {"moe.slots": 400, "moe.dropped": 6}}


@pytest.mark.parametrize("name", DEVICE_SHARES + DROP_SHARES)
def test_reader_share_from_a_stubbed_snapshot(monkeypatch, name):
    _stub(monkeypatch, SNAP)
    got = harness.load_reader(name)(_run())
    # moe: the events launched inside repro.moe, .experts, .bwd and
    # .combine.bwd (not the attention recomputed inside, not
    # repro.moe_other), over the root's busy time (idle left out)
    assert got == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", DEVICE_SHARES + DROP_SHARES)
def test_reader_reads_nothing_without_records(monkeypatch, name):
    read = harness.load_reader(name)
    _stub(monkeypatch, {"spans": {}, "counters": {}})
    assert read(_run(trace=_trace(spans=[]))) is None
    _stub(monkeypatch, SNAP)
    assert read(_run(traced=False)) is None
    if name in DROP_SHARES:           # a port without telemetry
        monkeypatch.delattr(sys.modules["repro_torch"], "telemetry")
        monkeypatch.setitem(sys.modules, "repro_torch.telemetry", None)
        assert read(_run()) is None


@pytest.mark.parametrize("name", DEVICE_SHARES)
def test_device_share_reads_nothing_from_cpu_times(monkeypatch, name):
    """No device events (a CPU run), or a pairing that cannot hold: a
    launch more than device events, or one fewer."""
    read = harness.load_reader(name)
    assert read(_run(trace=_trace(work=[]))) is None
    extra = types.SimpleNamespace(_host=_trace()._host + [
        (500, 501, "cudaLaunchKernel")], kernels=_trace().kernels)
    assert read(_run(trace=extra)) is None
    fewer = types.SimpleNamespace(_host=_trace()._host,
                                  kernels=_trace().kernels[:-1])
    assert read(_run(trace=fewer)) is None


def test_pairing_names_the_innermost_span_and_every_launch_api():
    got = spans.attribute(_trace(api="cuLaunchKernel"))
    assert [c[-1] for _, _, c in got] == [
        "repro.forward", "repro.moe", "repro.moe.experts",
        "repro.moe_other", "repro.moe.bwd", "repro.moe.combine.bwd",
        "repro.attn.recompute", "repro.optim", "repro.prefill",
        "repro.ssd", "repro.mamba", "repro.moe"]
    assert got[6][2] == ("repro.train_step", "repro.backward",
                         "repro.moe.bwd", "repro.moe.combine.bwd",
                         "repro.attn.recompute")
    assert spans.attribute(_trace(api="cudaStreamSynchronize")) is None


def test_smoke_traced_cpu_run_reads_a_drop_share():
    spec = smoke.spec("granite-moe.train", smoke.granite(), smoke.train_mix())
    run = harness.run_cell(spec, SEED, 0.2, True, torch.device("cpu"), 0.0)
    out = harness.result(spec, run, True, {"platform": "cpu"})
    share = out["metrics"]["moe_drop_share.train"]["value"]
    assert 0.0 <= share <= 100.0
    for name in ("moe_share.train", "optim_share.train"):
        assert name not in out["metrics"]        # no device times on a CPU
    spans = telemetry.snapshot()["spans"]
    assert spans["repro.train_step"]["calls"] == len(run.traced_units)
