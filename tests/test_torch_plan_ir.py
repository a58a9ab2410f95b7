"""The port's CommPlan IR against the JAX package's, bit for bit.

``repro_torch.core.plan_ir`` is a copy of ``repro.core.plan_ir`` on the
port's fabric engines.  Raised modules -- from flow lists of every
schedule, from ``raise_stencil`` and from ``raise_serving_wave`` -- must
equal the reference's op for op and as text (``str``); every pass and
the default guarded pipeline must rewrite to the reference's module;
``execute`` on the ``torch`` and ``cuda`` engines must equal the
reference's scalar oracle (``engine="reference"``) on every field of
the shared ``DRIVERS["ir"]`` table, with the port's adaptive cutoffs as
they are and forced to 0 (every batch through the staged scans and the
kernel's plain version); the guard never regresses, faults active or
not; the validation errors of ``tests/test_plan_ir.py`` are raised.
The ``ir_passes`` full grid reproduces ``BENCH_scenarios.json`` on
``torch`` and ``cuda`` and ``run_ir`` equals the reference runner.
Tolerance everywhere: exact.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # env without hypothesis: deterministic fallback
    from _hypo import given, settings, st

from _engines import DRIVERS, assert_results_equal
from repro.core import commplan as rcp
from repro.core import faults as rflt
from repro.core import plan_ir as rir
from repro.core import simulator as rsim
from repro.experiments import engine as rengine
from repro_torch.core import commplan as pcp
from repro_torch.core import fabric as pfb
from repro_torch.core import fabric_cuda as pfc
from repro_torch.core import faults as pflt
from repro_torch.core import plan_ir as pir
from repro_torch.core import simulator as psim
from repro_torch.experiments import SPECS, compare_to_baseline, run_spec
from repro_torch.experiments import engine as pengine

BASELINE = json.loads((pathlib.Path(__file__).resolve().parent.parent
                       / "BENCH_scenarios.json").read_text())
IR_FIELDS = DRIVERS["ir"].fields
PORT_ENGINES = ("torch", "cuda")
ALL_SCHEDULES = sorted(rsim.SCHEDULES)
PIPELINED = rir.PIPELINED
IR_GRID = SPECS["ir_passes"].points("full")

STENCIL_KW = dict(dims=(2, 2), theta=4, n_threads=2, n_vcis=2,
                  local_shape=(24, 8))
FAULTY_KW = dict(dims=(2, 2), theta=4, face_bytes=(65536.0, 65536.0),
                 n_vcis=2)
SERVING_KW = dict(arrival="bursty", rate_rps=14000.0, n_requests=24,
                  n_tenants=4, skew=1.0, n_stages=4, theta=8,
                  part_bytes=16384.0, n_vcis=4, compute_us=40.0, seed=3)


@pytest.fixture
def forced(monkeypatch):
    """Every port batch through the staged scans / kernels, however
    narrow (the port's own adaptive cutoffs set to 0)."""
    monkeypatch.setattr(pfb, "SCALAR_BATCH_CUTOFF", 0)
    monkeypatch.setattr(pfb, "MIN_GROUP_PARALLELISM", 0)


@pytest.fixture
def scans(monkeypatch):
    """Count the calls of the cuda engine's kernel wrapper (its plain
    version on the CPU)."""
    calls = []
    real = pfc.fabric_scan

    def counting(ops):
        calls.append(ops.n)
        return real(ops)
    monkeypatch.setattr(pfc, "fabric_scan", counting)
    return calls


def _scenarios(sim, seed, n_flows, n_ranks=4, n_vcis=2):
    """The reference suite's random multi-flow scenario list, built from
    one seed in either package."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_flows):
        n = int(rng.choice([1, 2]))
        theta = int(rng.choice([1, 2, 4]))
        src = int(rng.integers(0, n_ranks))
        dst = int((src + 1 + rng.integers(0, n_ranks - 1)) % n_ranks)
        out.append(sim.Scenario(
            n_threads=n, theta=theta,
            part_bytes=float(rng.choice([256.0, 2048.0, 65536.0])),
            ready=rng.uniform(0.0, 25e-6, size=(n, theta)),
            n_vcis=n_vcis, aggr_bytes=float(rng.choice([0.0, 8192.0])),
            src=src, dst=dst, t0=float(rng.choice([0.0, 5e-6]))))
    return out


def _modules(approach, seed, n_flows, n_ranks=4, n_vcis=2):
    """(reference module, port module) of one random flow list."""
    return tuple(ir.raise_scenarios(
        approach, _scenarios(sim, seed, n_flows, n_ranks, n_vcis),
        n_ranks=n_ranks, n_vcis=n_vcis)
        for ir, sim in ((rir, rsim), (pir, psim)))


def _ops(module):
    return [(type(op).__name__, dataclasses.astuple(op))
            for op in module.ops]


def assert_same_module(want, got):
    assert str(got) == str(want)
    assert _ops(got) == _ops(want)
    assert (got.approach, got.n_ranks, got.n_vcis) == \
        (want.approach, want.n_ranks, want.n_vcis)
    assert dataclasses.astuple(got.cfg) == dataclasses.astuple(want.cfg)
    assert len(got.ready_tables) == len(want.ready_tables)
    for a, b in zip(got.ready_tables, want.ready_tables):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _faults(pkg, drop_prob, seed):
    return None if drop_prob is None else pkg.FaultSpec(drop_prob=drop_prob,
                                                        seed=seed)


def _check_execute(rmod, pmod, faults=None, engines=PORT_ENGINES):
    """Port engines against the reference's scalar oracle."""
    drop, seed = faults or (None, 0)
    want = rir.execute(rmod, engine="reference",
                       faults=_faults(rflt, drop, seed))
    for engine in engines:
        got = pir.execute(pmod, engine=engine, device="cpu",
                          faults=_faults(pflt, drop, seed))
        assert_results_equal(want, got, IR_FIELDS,
                             context=f"[{engine}] ")
    return want


# ---------------------------------------------------------------------------
# Raising: the same modules, op for op and as text
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("approach", ALL_SCHEDULES)
def test_raised_modules_equal_reference(approach):
    for seed, n in ((7, 5), (1, 2)):
        rmod, pmod = _modules(approach, seed, n)
        assert_same_module(rmod, pmod)
        for fid, sc in enumerate(_scenarios(psim, seed, n)):
            assert pir.plan_of(pmod, fid) == sc.request().plan
            assert pir.plan_of(pmod, fid).messages == tuple(
                pcp.WireMessage(m.index, m.items, m.nbytes, m.channel)
                for m in rir.plan_of(rmod, fid).messages)
    assert bool(pmod.barriers()) == (approach == "part")


@pytest.mark.parametrize("approach", PIPELINED)
def test_raised_stencil_equals_reference(approach):
    assert_same_module(rir.raise_stencil(approach, **STENCIL_KW),
                       pir.raise_stencil(approach, **STENCIL_KW))
    plans = {0: (2, 8192.0, 2), 1: (8, 0.0, 1)}
    kw = dict(dims=(2, 3), theta=4, face_bytes=(4096.0, 65536.0),
              n_vcis=2, dim_plans=plans)
    assert_same_module(rir.raise_stencil(approach, **kw),
                       pir.raise_stencil(approach, **kw))


@pytest.mark.parametrize("plan_spec", [None, (4, 65536.0, 2)])
def test_raised_serving_wave_equals_reference(plan_spec):
    assert_same_module(
        rir.raise_serving_wave("part", plan_spec=plan_spec, **SERVING_KW),
        pir.raise_serving_wave("part", plan_spec=plan_spec, **SERVING_KW))


def test_module_from_plan_equals_reference():
    want = rir.module_from_plan(rcp.plan_uniform(8, 8, 512.0), n_threads=2,
                                part_bytes=512.0, n_vcis=2)
    got = pir.module_from_plan(pcp.plan_uniform(8, 8, 512.0), n_threads=2,
                               part_bytes=512.0, n_vcis=2)
    assert_same_module(want, got)


# ---------------------------------------------------------------------------
# Execution: torch and cuda against the reference's scalar oracle
# ---------------------------------------------------------------------------

CASES = {
    **{f"stencil-{ap}": (lambda ir, ap=ap: ir.raise_stencil(ap, **STENCIL_KW),
                         None) for ap in PIPELINED},
    **{f"random-{ap}-{seed}": (
        lambda ir, ap=ap, seed=seed: _modules(ap, seed, 6)[ir is pir], None)
        for ap in PIPELINED for seed in (0, 3)},
    "serving": (lambda ir: ir.raise_serving_wave("part", **SERVING_KW), None),
    "faulty": (lambda ir: ir.raise_stencil("part", **FAULTY_KW), (0.05, 2)),
    "faulty-many": (lambda ir: ir.raise_stencil("pt2pt_many", **FAULTY_KW),
                    (0.05, 1)),
}
# Cases on the NumPy faulty fabric (drops): the kernel is never reached.
FAULTY_CASES = ("faulty", "faulty-many")


@pytest.mark.parametrize("case", sorted(CASES))
def test_execute_equals_reference(case):
    make, faults = CASES[case]
    _check_execute(make(rir), make(pir), faults)


@pytest.mark.parametrize("case", sorted(CASES))
def test_execute_equals_reference_forced(case, forced, scans):
    make, faults = CASES[case]
    _check_execute(make(rir), make(pir), faults)
    if case in FAULTY_CASES:
        assert scans == []
    else:
        assert scans, f"{case}: the kernel's wrapper was never called"


@given(approach=st.sampled_from(PIPELINED),
       n_flows=st.sampled_from([1, 3, 6]), seed=st.integers(0, 50),
       n_vcis=st.sampled_from([1, 2, 4]))
@settings(max_examples=15, deadline=None)
def test_execute_equals_reference_sampled(approach, n_flows, seed, n_vcis):
    rmod, pmod = _modules(approach, seed, n_flows, n_vcis=n_vcis)
    assert_same_module(rmod, pmod)
    _check_execute(rmod, pmod)
    for name in PASS_NAMES[1:]:
        want = getattr(rir, name)().run(rmod)
        got = getattr(pir, name)().run(pmod)
        assert_same_module(want, got)
        _check_execute(want, got, engines=("cuda",))


def test_raised_stencil_equals_the_port_driver():
    """The anchor: a freshly raised module reproduces the port's own
    driver on both device engines."""
    mod = pir.raise_stencil("part", **STENCIL_KW)
    for engine in PORT_ENGINES:
        ir = pir.execute(mod, engine=engine, device="cpu")
        rv = psim.simulate_stencil("part", engine=engine, device="cpu",
                                   **STENCIL_KW)
        assert ir.rank_tts_s == rv.rank_tts_s
        assert (ir.tts_s, ir.time_s, ir.n_messages) == \
            (rv.tts_s, rv.time_s, rv.n_messages)


def test_execute_and_pipeline_resolve_the_device_first():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    mod = pir.raise_stencil("part", **STENCIL_KW)
    with pytest.raises(RuntimeError, match="cuda"):
        pir.execute(mod, engine="vector")
    with pytest.raises(RuntimeError, match="cuda"):
        pir.default_pipeline(engine="vector").run(mod)
    with pytest.raises(RuntimeError, match="cuda"):
        pir.PassPipeline(passes=[]).run(mod)
    with pytest.raises(RuntimeError, match="cuda"):
        pengine.run_ir(IR_GRID[0])


# ---------------------------------------------------------------------------
# Passes: the reference's rewrites, and the guard
# ---------------------------------------------------------------------------

PASS_NAMES = ("Canonicalize", "FuseFaces", "MergeSmallFlows",
              "GlobalChannels")


def _pass_inputs():
    yield "stencil", rir.raise_stencil("part", **STENCIL_KW), \
        pir.raise_stencil("part", **STENCIL_KW)
    yield "serving", rir.raise_serving_wave("part", **SERVING_KW), \
        pir.raise_serving_wave("part", **SERVING_KW)
    for seed in (0, 1, 2):
        yield f"random-{seed}", *_modules("part", seed, 5)
    yield "many", *_modules("pt2pt_many", 2, 3)


@pytest.mark.parametrize("name", PASS_NAMES)
def test_each_pass_rewrites_as_the_reference(name):
    for label, rmod, pmod in _pass_inputs():
        want = getattr(rir, name)().run(rmod)
        got = getattr(pir, name)().run(pmod)
        assert (got is pmod) == (want is rmod), label
        assert_same_module(want, got)
    small = [psim.Scenario(n_threads=1, theta=8, part_bytes=256.0,
                           ready=np.zeros((1, 8)), n_vcis=2)]
    mod = pir.raise_scenarios("part", small, n_ranks=2, n_vcis=2)
    assert pir.MergeSmallFlows(bound=8192.0).run(mod).n_wire == 1
    assert sorted(pir.PASSES) == sorted(rir.PASSES)


@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_default_pipeline_rewrites_as_the_reference(engine):
    """The guarded pipeline on the port's engine keeps the passes the
    reference keeps, and hands back the same module; under faults too."""
    inputs = [(lab, r, p, None) for lab, r, p in _pass_inputs()]
    inputs.append(("faulty", rir.raise_stencil("part", **FAULTY_KW),
                   pir.raise_stencil("part", **FAULTY_KW), (0.05, 1)))
    for label, rmod, pmod, faults in inputs:
        drop, seed = faults or (None, 0)
        rpipe = rir.default_pipeline(engine="reference")
        want = rpipe.run(rmod, faults=_faults(rflt, drop, seed))
        ppipe = pir.default_pipeline(engine=engine, device="cpu")
        got = ppipe.run(pmod, faults=_faults(pflt, drop, seed))
        assert ppipe.applied == rpipe.applied, label
        assert_same_module(want, got)
        _check_execute(want, got, faults, engines=(engine,))


def test_optimize_plan_equals_reference():
    for total, nt in ((64 * 256.0, 1), (8 * 1024.0, 2)):
        rplan, _ = rcp.plan_auto(total, n_threads=nt, max_vcis=2)
        pplan, _ = pcp.plan_auto(total, n_threads=nt, max_vcis=2)
        kw = dict(n_threads=nt, part_bytes=total / rplan.n_items, n_vcis=2)
        want = rir.optimize_plan(rplan, rir.default_pipeline(
            engine="reference"), **kw)
        got = pir.optimize_plan(pplan, pir.default_pipeline(
            engine="cuda", device="cpu"), **kw)
        assert [(m.index, m.items, m.nbytes, m.channel)
                for m in got.messages] == \
            [(m.index, m.items, m.nbytes, m.channel) for m in want.messages]
        assert len(got.messages) <= len(pplan.messages)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_guarded_pipeline_never_regresses(seed):
    _, mod = _modules("part", seed, 5)
    pipe = pir.default_pipeline(engine="cuda", device="cpu")
    out = pipe.run(mod)
    assert (pir.execute(out, engine="cuda", device="cpu").tts_s
            <= pir.execute(mod, engine="cuda", device="cpu").tts_s)
    assert all(name in pir.PASSES for name in pipe.applied)
    empty = pir.PassPipeline(passes=[], engine="cuda", device="cpu")
    assert empty.run(mod) is mod and empty.applied == []


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_guarded_pipeline_never_regresses_under_faults(seed):
    spec = pflt.FaultSpec(drop_prob=0.05, seed=seed)
    mod = pir.raise_stencil("part", **FAULTY_KW)
    out = pir.default_pipeline(engine="torch", device="cpu").run(
        mod, faults=spec)
    assert (pir.execute(out, engine="torch", device="cpu",
                        faults=spec).tts_s
            <= pir.execute(mod, engine="torch", device="cpu",
                           faults=spec).tts_s)


# ---------------------------------------------------------------------------
# Validation and error paths (tests/test_plan_ir.py)
# ---------------------------------------------------------------------------

def _tiny_module(**overrides):
    """A minimal valid 1-flow partitioned module to mutate."""
    ops = (pir.FlowOp(src=0, dst=1, n_threads=1, theta=2,
                      part_bytes=64.0, ready_class=0),
           pir.PartitionMapOp(flow=0, groups=((0,), (1,)),
                              nbytes=(64.0, 64.0)),
           pir.ChannelAssignOp(flow=0, channels=(0, 1)),
           pir.BarrierOp(flow=0, n_threads=1))
    kw = dict(approach="part", n_ranks=2, n_vcis=2,
              ready_tables=(np.zeros((1, 2)),), ops=ops)
    kw.update(overrides)
    return pir.Module(**kw)


def _replace_op(kind, new):
    base = _tiny_module()
    return _tiny_module(ops=tuple(new if isinstance(op, kind) else op
                                  for op in base.ops))


@pytest.mark.parametrize("make,match", [
    (lambda: _tiny_module(approach="warp"), "unknown approach"),
    (lambda: _tiny_module(n_ranks=1), "endpoints outside"),
    (lambda: _tiny_module(ready_tables=()), "ready_class 0 unbound"),
    (lambda: _tiny_module(ready_tables=(np.zeros((2, 2)),)),
     "ready table shape"),
    (lambda: _tiny_module(ops=_tiny_module().ops + (pir.PartitionMapOp(
        flow=0, groups=((0,),), nbytes=(64.0,)),)),
     "more than one PartitionMapOp"),
    (lambda: _tiny_module(ops=_tiny_module().ops + (pir.ChannelAssignOp(
        flow=0, channels=(0,)),)), "more than one ChannelAssignOp"),
    (lambda: _tiny_module(ops=_tiny_module().ops + (pir.PartitionMapOp(
        flow=5, groups=((0,),), nbytes=(64.0,)),)),
     "more than one|unknown flow"),
    (lambda: _replace_op(pir.PartitionMapOp, pir.PartitionMapOp(
        flow=0, groups=((0,),), nbytes=(64.0,))), "cover 0..1"),
    (lambda: _replace_op(pir.PartitionMapOp, pir.PartitionMapOp(
        flow=0, groups=((0, 0), (1,)), nbytes=(128.0, 64.0))), "cover 0..1"),
    (lambda: _replace_op(pir.PartitionMapOp, pir.PartitionMapOp(
        flow=0, groups=((0,), (1,)), nbytes=(64.0,))), "payload"),
    (lambda: _replace_op(pir.ChannelAssignOp, pir.ChannelAssignOp(
        flow=0, channels=(0,))), "channels for"),
    (lambda: _tiny_module(ops=_tiny_module().ops[:1]),
     "missing partition map"),
], ids=["approach", "endpoints", "unbound", "shape", "dup-pmap",
        "dup-chan", "dangling", "uncovered", "repeated", "payload",
        "channels", "missing"])
def test_validation_errors(make, match):
    _tiny_module().validate()
    with pytest.raises(ValueError, match=match):
        make().validate()


def test_error_paths():
    _, mod = _modules("rma_many_passive", 0, 2)
    with pytest.raises(ValueError, match="dependent traffic"):
        pir.lower(mod)
    with pytest.raises(ValueError, match="dependent traffic"):
        pir.execute(mod, engine="cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown approach"):
        pir.raise_scenarios("warp", [], n_ranks=2, n_vcis=1)
    with pytest.raises(ValueError, match="n_stages"):
        pir.raise_serving_wave("part", rate_rps=1e3, n_requests=4,
                               n_stages=1, theta=2, part_bytes=64.0)
    with pytest.raises(ValueError, match="dim_plans"):
        pir.raise_stencil("part", dims=(2, 2), theta=2,
                          face_bytes=(256.0, 256.0), ready=np.zeros((1, 2)),
                          dim_plans={0: (4, 0.0, 1)})
    with pytest.raises(ValueError, match="split over"):
        pir.module_from_plan(pcp.plan_uniform(5, 5, 64.0), n_threads=2,
                             part_bytes=64.0, n_vcis=1)
    with pytest.raises(ValueError, match="uniform form"):
        pcp.plan_auto(sizes=[512.0, 512.0],
                      pipeline=pir.default_pipeline(device="cpu"))


# ---------------------------------------------------------------------------
# The ir_passes spec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_ir_passes_full_grid_reproduces_baseline(engine):
    results = run_spec(SPECS["ir_passes"], mode="full", engine=engine,
                       device="cpu")
    assert len(results) == 6
    violations = compare_to_baseline(BASELINE, {"ir_passes": results})
    assert not violations, "\n".join(violations)
    records = BASELINE["specs"]["ir_passes"]["records"]
    for key, metrics in results.items():
        for name in ("n_messages", "n_flows", "n_wire_pointwise",
                     "n_wire_ir", "n_passes_applied", "n_retransmits"):
            assert metrics[name] == records[key][name], (key, name)
        assert metrics["ir_us"] <= metrics["pointwise_us"], key


def test_ir_passes_torch_equals_cuda():
    assert run_spec(SPECS["ir_passes"], "full", engine="torch",
                    device="cpu") == \
        run_spec(SPECS["ir_passes"], "full", engine="cuda", device="cpu")


@pytest.mark.parametrize("params", IR_GRID, ids=pengine.record_key)
def test_run_ir_equals_reference_runner(params):
    want = rengine.run_ir(params, engine="reference")
    assert pengine.run_ir(params, engine="reference", device="cpu") == want
    assert pengine.run_ir(params, engine="cuda", device="cpu") == want


def test_ir_passes_launches_no_kernel_unforced(scans):
    """Under the default cutoffs every batch of the 6 records is narrow
    enough for the scalar path, as in the reference: no wrapper call."""
    pengine._CACHE.clear()
    run_spec(SPECS["ir_passes"], "full", engine="cuda", device="cpu")
    run_spec(SPECS["autotune"], "full", engine="cuda", device="cpu")
    assert scans == []


def test_ir_passes_forced_reaches_the_kernel(forced, scans):
    """With the cutoffs at 0 each fault-free record reaches the
    kernel's wrapper and still equals the reference's oracle."""
    for params in IR_GRID:
        if params["scenario"] == "faults":
            continue
        scans.clear()
        got = pengine.run_ir(params, engine="cuda", device="cpu")
        assert got == rengine.run_ir(params, engine="reference")
        assert len(scans) >= 4, (params, scans)
