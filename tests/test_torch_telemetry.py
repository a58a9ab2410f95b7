"""The port's spans and device counters (``repro_torch.telemetry``).

Off (no profile recording) they open no profiler range, record no
CUDA event, keep no record and add no autograd node, and outputs and
gradients are bitwise those of a run under a profile.  On, under a CPU
``torch.profiler`` profile: nested spans carry their parents and lie in
the profile, self times are the duration less the children, backward
and recomputation spans appear once a layer a step, and the MoE's
counters equal a plain recount of its capacity drops.  On the card a
span adds no device work.
"""

import tempfile

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from repro_torch import telemetry
from repro_torch.configs import granite_moe_3b_a800m as granite
from repro_torch.launch import steps
from repro_torch.models.moe import MoE, MoEConfig, init_moe, moe_fwd
from repro_torch.models.tp import TP

B, S = 2, 32


@pytest.fixture(scope="module", autouse=True)
def group():
    """A one-rank gloo group for the module (the sync's all-reduces)."""
    if dist.is_initialized():
        yield
        return
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", store=dist.FileStore(f"{d}/s", 1),
                                rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


@pytest.fixture(autouse=True)
def fresh():
    telemetry.reset()
    yield
    telemetry.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _moe(mo: MoEConfig, d: int = 16, seed: int = 0):
    p = MoE(d, mo, dtype=torch.float32, device="cpu")
    init_moe(p, torch.Generator().manual_seed(seed), mo)
    return p.requires_grad_(True)


MO = MoEConfig(n_experts=8, top_k=2, d_expert=8, capacity_factor=0.5,
               min_capacity=1)


def _moe_run(p, x, **kw):
    x = x.clone().requires_grad_(True)
    y = moe_fwd(p, x, mo=MO, **kw)
    y.square().sum().backward()
    grads = [x.grad] + [q.grad for q in p.parameters()]
    for q in p.parameters():
        q.grad = None
    return y.detach(), grads


def _train(on: bool, n_steps: int = 2, sync_mode: str = "partitioned"):
    """``n_steps`` tiny granite-moe training steps (2 layers, remat, f32)
    with or without a profile recording; (params, first moments)."""
    cfg = granite.smoke_config()
    scfg = steps.StepConfig(sync_mode=sync_mode, aggr_bytes=1 << 12,
                            param_dtype="float32", remat=True,
                            warmup_steps=1, total_steps=10)
    state = steps.build_state(cfg, seed=0, device="cpu")
    fn = steps.make_train_step(cfg, scfg, seq_len=S, batch=B, device="cpu")
    gen = torch.Generator().manual_seed(1)
    batches = [{k: torch.randint(0, cfg.vocab, (B, S), generator=gen)
                for k in ("tokens", "labels")} for _ in range(n_steps)]
    with (_cpu_profile() if on else _Nothing()):
        for b in batches:
            state, _ = fn(state, b)
    return ({k: p.detach().clone()
             for k, p in state["params"].named_parameters()},
            {k: m.clone() for k, m in state["opt"]["m"].items()})


class _Nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _raise(*a, **k):
    raise AssertionError("called while no profile records")


def _parents():
    """(name, parent's name) of every recorded span, in opening order."""
    r = telemetry._R
    return [(n, r.names[p] if p >= 0 else None)
            for n, p in zip(r.names, r.parents)]


def test_off_opens_nothing_and_keeps_nothing(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(telemetry, "_Range", _raise)
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    x = torch.randn(3, 4, requires_grad=True)
    assert telemetry.mark_in(x, "r") is x
    assert telemetry.mark_out(x, "r") is x
    assert telemetry.span("a") is telemetry.span("b")
    telemetry.count("c", 3)
    p = _moe(MO)
    _moe_run(p, torch.randn(2, 16, 16))
    _train(False, n_steps=1)
    snap = telemetry.snapshot()
    assert snap == {"spans": {}, "counters": {}}


def test_outputs_and_gradients_equal_on_and_off():
    p = _moe(MO)
    x = torch.randn(2, 16, 16, generator=torch.Generator().manual_seed(2))
    y0, g0 = _moe_run(p, x)
    with _cpu_profile():
        y1, g1 = _moe_run(p, x)
    assert torch.equal(y0, y1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    assert telemetry.snapshot()["spans"]["repro.moe.experts.bwd"][
        "calls"] == 1
    off, on = _train(False), _train(True)
    _equal(off[0], on[0])
    _equal(off[1], on[1])


def test_nested_spans_parents_units_and_self_time():
    with _cpu_profile() as prof:
        for _ in range(2):
            with telemetry.span("t.root"):
                with telemetry.span("t.a"):
                    with telemetry.span("t.b"):
                        torch.ones(64).sum()
                with telemetry.span("t.c"):
                    torch.ones(64).sum()
    assert _parents()[:5] == [("t.root", None), ("t.a", "t.root"),
                              ("t.b", "t.a"), ("t.c", "t.root"),
                              ("t.root", None)]
    assert list(telemetry._R.parents[:4]) == [-1, 0, 1, 0]
    snap = telemetry.snapshot()["spans"]
    assert snap["t.root"]["calls"] == 2 and snap["t.b"]["calls"] == 2
    for name, kids in (("t.root", ("t.a", "t.c")), ("t.a", ("t.b",))):
        want = snap[name]["host_s"] - sum(snap[k]["host_s"] for k in kids)
        assert snap[name]["host_self_s"] == pytest.approx(want, abs=1e-9)
    assert snap["t.b"]["host_self_s"] == snap["t.b"]["host_s"]
    assert all(set(v) == {"calls", "host_s", "host_self_s"}
               for v in snap.values())
    names = {e.name for e in prof.events()}
    assert {"t.root", "t.a", "t.b", "t.c"} <= names


def test_remat_train_step_records_backward_and_recompute_spans():
    n_steps, n_layers = 2, granite.smoke_config().n_layers
    off = _train(False, n_steps)
    on = _train(True, n_steps)
    _equal(off[0], on[0])
    _equal(off[1], on[1])
    spans = telemetry.snapshot()["spans"]
    per = n_steps * n_layers
    for name in ("repro.moe.bwd", "repro.moe.experts.bwd",
                 "repro.moe.combine.bwd", "repro.attn.bwd",
                 "repro.moe.recompute", "repro.attn.recompute",
                 "repro.moe", "repro.attn", "repro.sync.layer"):
        assert spans[name]["calls"] == per, name
    for name in ("repro.train_step", "repro.forward", "repro.loss",
                 "repro.backward", "repro.sync", "repro.optim"):
        assert spans[name]["calls"] == n_steps, name
    by = {}
    for name, parent in _parents():
        by.setdefault(name, set()).add(parent)
    assert by["repro.train_step"] == {None}
    assert by["repro.moe.bwd"] == {"repro.backward"}
    assert by["repro.moe.experts.bwd"] == {"repro.moe.bwd"}
    assert by["repro.moe.route"] == {"repro.moe"}
    assert by["repro.moe.route.recompute"] == {"repro.moe.recompute"}
    assert by["repro.sync.layer"] == {"repro.backward"}
    # the forward counted each slot once; the recomputation did not
    assert telemetry.snapshot()["counters"]["moe.slots"] == \
        n_steps * n_layers * B * S * granite.smoke_config().moe.top_k


def _recount(p, x: torch.Tensor, mo: MoEConfig) -> int:
    """Slots past their expert's capacity, counted token by token."""
    t = x.shape[0] * x.shape[1]
    logits = x.reshape(t, -1) @ p.router
    idx = torch.topk(logits.float(), mo.top_k, dim=-1).indices
    cap, seen, dropped = mo.capacity(t), {}, 0
    for e in idx.reshape(-1).tolist():
        seen[e] = seen.get(e, 0) + 1
        dropped += seen[e] > cap
    return dropped


def test_moe_counters_equal_a_plain_recount():
    p = _moe(MO, seed=3)
    x = torch.randn(1, 64, 16, generator=torch.Generator().manual_seed(4))
    with _cpu_profile(), torch.no_grad():
        moe_fwd(p, x, mo=MO)
    got = telemetry.snapshot()["counters"]
    want = _recount(p, x, MO)
    assert want > 0
    assert got == {"moe.slots": 64 * MO.top_k, "moe.dropped": want}


def test_expert_parallel_counts_on_model_rank_0_only():
    p = _moe(MO, seed=3)
    x = torch.randn(1, 64, 16, generator=torch.Generator().manual_seed(4))
    for rank in (1, 0):
        held = MoE(16, MO, dtype=torch.float32, device="cpu")
        with torch.no_grad():
            held.router.copy_(p.router)
            for k in ("w_gate", "w_up", "w_down"):
                full = getattr(p, k)
                setattr(held, k, torch.nn.Parameter(
                    full[rank * 4:(rank + 1) * 4].clone(),
                    requires_grad=False))
        with _cpu_profile(), torch.no_grad():
            moe_fwd(held, x, mo=MO, tp=TP(group=None, size=2, rank=rank))
        got = telemetry.snapshot()["counters"]
        assert got == ({} if rank else {"moe.slots": 64 * MO.top_k,
                                        "moe.dropped": _recount(p, x, MO)})


def test_off_then_on_clears_the_records():
    with _cpu_profile():
        with telemetry.span("first"):
            telemetry.count("n", 2)
    assert set(telemetry.snapshot()["spans"]) == {"first"}
    with telemetry.span("between"):   # off: nothing
        pass
    with _cpu_profile():
        with telemetry.span("second"):
            telemetry.count("n", torch.tensor(5))
    snap = telemetry.snapshot()
    assert set(snap["spans"]) == {"second"}
    assert snap["counters"] == {"n": 5}
    with _cpu_profile():              # no call of the port in between:
        with telemetry.span("third"):  # the snapshot saw the switch
            pass
    assert set(telemetry.snapshot()["spans"]) == {"third"}


def test_an_unmatched_mark_is_dropped():
    w = torch.randn(4, requires_grad=True)
    with _cpu_profile():
        with telemetry.span("root"):
            x = telemetry.mark_in(w * 1.0, "lost")
            # the region's output does not depend on its marked input, so
            # the input's backward never runs and its span never closes
            y = telemetry.mark_out(w * 2.0 + 0 * x.detach(), "lost")
            with telemetry.span("bwd"):
                y.sum().backward()
            with telemetry.span("after"):
                pass
    spans = telemetry.snapshot()["spans"]
    assert "lost.bwd" not in spans
    assert {"root", "bwd", "after"} <= set(spans)
    assert ("after", "root") in _parents()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_spans_add_no_device_work_on_the_card(cuda, monkeypatch):
    p = _moe(MO, seed=3)
    x = torch.randn(2, 64, 16, generator=torch.Generator().manual_seed(4))
    want = _recount(p, x, MO)
    p = p.to(cuda)
    cuda_t = torch.autograd.DeviceType.CUDA

    def traced():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with telemetry.span("root"):
                y = moe_fwd(p, x.to(cuda).requires_grad_(True), mo=MO)
                y.square().sum().backward()
            torch.cuda.synchronize(cuda)
        return (sorted(e.name for e in prof.events()
                       if e.device_type == cuda_t),
                {e.name for e in prof.events()})

    snap = (traced(), telemetry.snapshot())
    assert snap[1]["counters"] == {"moe.slots": 128 * MO.top_k,
                                   "moe.dropped": want}
    monkeypatch.setattr(telemetry, "counting", lambda: False)
    spanned, host = traced()
    monkeypatch.setattr(telemetry, "_active", lambda: False)
    plain, _ = traced()
    # the spans lie in the profile among the host operations, and bring
    # no device event (no kernel, no copy, no mirrored range)
    assert {"root", "repro.moe.route", "repro.moe.experts.bwd",
            "repro.moe.combine.bwd"} <= host
    assert spanned == plain
