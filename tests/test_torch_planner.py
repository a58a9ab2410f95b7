"""The port's planner against the JAX package's, bit for bit.

``repro_torch.core.planner`` is a copy of ``repro.core.planner`` whose
arithmetic must not move: every candidate's predicted time and named
terms, the ranking (ties broken by grid order), the choice and the
``explain`` text must equal the reference's exactly in float64, over
the ``autotune`` spec's full grid and a hypothesis sample of scenario
descriptors (faults and recovery policies included).  The plans built
from the choice -- ``commplan.plan_auto`` in both forms,
``PartitionedRequest.auto``, ``bucketing.make_plan(..., "auto")`` on
llama3.2-1b's leaves and ``earlybird.auto_sync_config`` -- must equal
the reference's field for field.  The ``autotune`` full grid reproduces
``BENCH_scenarios.json`` on the port's ``torch`` and ``cuda`` engines,
and ``run_autotune`` equals the reference runner on engine
``reference``.  The property cases of ``tests/test_planner.py`` run
again on the port.  Tolerance everywhere: exact.
"""

import dataclasses
import json
import math
import pathlib

import jax
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # env without hypothesis: deterministic fallback
    from _hypo import given, settings, st

from repro.configs import get_config as jget
from repro.core import bucketing as rb
from repro.core import commplan as rcp
from repro.core import earlybird as reb
from repro.core import faults as rflt
from repro.core import partition as rpart
from repro.core import perfmodel as rpm
from repro.core import planner as rpl
from repro.core import recovery as rrec
from repro.experiments import SPECS as REF_SPECS
from repro.experiments import engine as rengine
from repro.models import lm as jlm
from repro_torch.configs import get_config as pget
from repro_torch.core import bucketing as pb
from repro_torch.core import commplan as pcp
from repro_torch.core import earlybird as peb
from repro_torch.core import fabric as pfb
from repro_torch.core import faults as pflt
from repro_torch.core import partition as ppart
from repro_torch.core import perfmodel as ppm
from repro_torch.core import planner as ppl
from repro_torch.core import plan_ir as pir
from repro_torch.core import recovery as prec
from repro_torch.experiments import SPECS, compare_to_baseline, run_spec
from repro_torch.experiments import engine as pengine
from repro_torch.models import lm as plm

BASELINE = json.loads((pathlib.Path(__file__).resolve().parent.parent
                       / "BENCH_scenarios.json").read_text())
GRID = SPECS["autotune"].points("full")
WORKLOADS = {"none": (None, None), "fft": (rpm.FFT, ppm.FFT),
             "stencil": (rpm.STENCIL, ppm.STENCIL)}


def _choice(ch):
    """A PlanChoice as plain values (the two packages' classes differ)."""
    return (ch.approach, ch.theta, ch.aggr_bytes, ch.n_vcis, ch.predicted_s,
            ch.terms)


def _plan(plan):
    return ([(m.index, m.items, m.nbytes, m.channel) for m in plan.messages],
            plan.n_items)


def _descs(total_bytes, n_threads=1, workload="none", drop_prob=0.0,
           policy=None, **kw):
    """The same scenario descriptor in both packages."""
    rw, pw = WORKLOADS[workload]
    rf = pf = None
    if drop_prob:
        rf = rflt.FaultSpec(drop_prob=drop_prob, seed=1)
        pf = pflt.FaultSpec(drop_prob=drop_prob, seed=1)
    rp = None if policy is None else rrec.make_policy(policy)
    pp = None if policy is None else prec.make_policy(policy)
    return (rpl.ScenarioDesc(total_bytes=float(total_bytes),
                             n_threads=n_threads, workload=rw, faults=rf,
                             policy=rp, **kw),
            ppl.ScenarioDesc(total_bytes=float(total_bytes),
                             n_threads=n_threads, workload=pw, faults=pf,
                             policy=pp, **kw))


def _assert_same_ranking(rdesc, pdesc, **kw):
    want = rpl.rank_plans(rdesc, **kw)
    got = ppl.rank_plans(pdesc, **kw)
    assert [_choice(c) for c in got] == [_choice(c) for c in want]
    assert [ppl.explain(pdesc, c) for c in got] == \
        [rpl.explain(rdesc, c) for c in want]
    assert _choice(ppl.choose_plan(pdesc, **kw)) == _choice(want[0])
    return got


# ---------------------------------------------------------------------------
# The model against the reference's
# ---------------------------------------------------------------------------

def test_constants_and_grids_equal_the_reference():
    for name in ("TPU_ICI_BETA", "TPU_HBM_BETA", "TPU_PEAK_FLOPS",
                 "TPU_DCN_BETA"):
        assert getattr(ppm, name) == getattr(rpm, name), name
    assert dataclasses.astuple(ppl.TPU_NET) == \
        dataclasses.astuple(rpl.TPU_NET)
    for name in ("PLANNER_APPROACHES", "DEFAULT_THETAS",
                 "DEFAULT_AGGR_BYTES", "DEFAULT_VCIS"):
        assert getattr(ppl, name) == getattr(rpl, name), name
    assert dataclasses.asdict(ppl.training_workload()) == \
        dataclasses.asdict(rpl.training_workload())


@pytest.mark.parametrize("params", GRID, ids=pengine.record_key)
def test_ranking_equals_reference_on_autotune_grid(params):
    want = rengine.autotune_desc(params)
    got = pengine.autotune_desc(params)
    ranked = _assert_same_ranking(want, got)
    assert [dataclasses.astuple(c) for c in ppl.candidate_grid(got)] == \
        [dataclasses.astuple(c) for c in rpl.candidate_grid(want)]
    assert len(ranked) == len(rpl.candidate_grid(want))


@given(total_bytes=st.sampled_from([64, 4096, 100_000, 1 << 20, 16 << 20,
                                    3_000_000]),
       n_threads=st.sampled_from([1, 2, 3, 4, 8, 16, 32]),
       workload=st.sampled_from(sorted(WORKLOADS)),
       max_parts=st.sampled_from([1, 8, 64, 512]),
       max_vcis=st.sampled_from([1, 4, 32]),
       drop_prob=st.sampled_from([0.0, 0.0, 0.01, 0.05]),
       policy=st.sampled_from([None, "fixed", "adaptive", "hedged"]))
@settings(max_examples=40, deadline=None)
def test_ranking_equals_reference_sampled(total_bytes, n_threads, workload,
                                          max_parts, max_vcis, drop_prob,
                                          policy):
    rdesc, pdesc = _descs(total_bytes, n_threads, workload, drop_prob,
                          policy, max_parts=max(max_parts, n_threads),
                          max_vcis=max_vcis)
    _assert_same_ranking(rdesc, pdesc)
    _assert_same_ranking(rdesc, pdesc, approaches=("part",))
    for theta in (1, 3, 8):
        got, want = pdesc.ready(theta), rdesc.ready(theta)
        assert (got is None and want is None) or np.array_equal(got, want)


def test_restricted_axes_equal_reference():
    rdesc, pdesc = _descs(1 << 20, 4, "fft")
    kw = dict(thetas=(2, 16), aggr_bytes=(0.0, 8192.0), vcis=(1, 3),
              approaches=("pt2pt_many", "part"))
    _assert_same_ranking(rdesc, pdesc, **kw)


# ---------------------------------------------------------------------------
# The plans built from the choice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(total_bytes=float(4 << 20), n_threads=4, workload="fft"),
    dict(total_bytes=64 * 256.0, n_threads=1, max_vcis=2),
    dict(total_bytes=float(1 << 20), n_threads=2, workload="stencil",
         max_parts=16, max_vcis=4),
    dict(total_bytes=131072.0, n_threads=1, max_vcis=2, drop_prob=0.02),
    dict(total_bytes=float(16 << 20), n_threads=8, drop_prob=0.01,
         policy="adaptive"),
], ids=["fft", "small", "stencil", "faults", "policy"])
def test_plan_auto_uniform_equals_reference(case):
    case = dict(case)
    rw, pw = WORKLOADS[case.pop("workload", "none")]
    drop = case.pop("drop_prob", 0.0)
    policy = case.pop("policy", None)
    rf = rflt.FaultSpec(drop_prob=drop, seed=3) if drop else None
    pf = pflt.FaultSpec(drop_prob=drop, seed=3) if drop else None
    want, wch = rcp.plan_auto(workload=rw, faults=rf, policy=policy, **case)
    got, gch = pcp.plan_auto(workload=pw, faults=pf, policy=policy, **case)
    assert _plan(got) == _plan(want)
    assert _choice(gch) == _choice(wch)


@pytest.mark.parametrize("sizes", [
    [100_000.0] * 37,
    np.random.default_rng(0).uniform(1.0, 3e6, size=50).tolist(),
    [512.0, 512.0],
], ids=["uniform37", "random50", "two"])
def test_plan_auto_sized_equals_reference(sizes):
    want, wch = rcp.plan_auto(sizes=sizes, max_vcis=8)
    got, gch = pcp.plan_auto(sizes=sizes, max_vcis=8)
    assert _plan(got) == _plan(want)
    assert _choice(gch) == _choice(wch)
    assert got.total_bytes == sum(sizes)


def test_plan_auto_pipeline_equals_reference():
    """The ``pipeline=`` hook: the pointwise pick rewritten by the IR's
    guarded passes, graded on the port's engines."""
    from repro.core import plan_ir as rir
    for total, nt in ((64 * 256.0, 1), (8 * 1024.0, 2), (1 << 20, 1)):
        want, _ = rcp.plan_auto(total, n_threads=nt, max_vcis=2,
                                pipeline=rir.default_pipeline(
                                    engine="reference"))
        for engine in ("torch", "cuda"):
            got, _ = pcp.plan_auto(total, n_threads=nt, max_vcis=2,
                                   pipeline=pir.default_pipeline(
                                       engine=engine, device="cpu"))
            assert _plan(got) == _plan(want), (total, nt, engine)


@pytest.mark.parametrize("total,nt,workload", [
    (float(4 << 20), 4, "stencil"), (float(1 << 20), 1, "fft"),
    (3000.0, 2, "none")])
def test_partitioned_request_auto_equals_reference(total, nt, workload):
    rw, pw = WORKLOADS[workload]
    want = rpart.PartitionedRequest.auto(total, n_threads=nt, workload=rw)
    got = ppart.PartitionedRequest.auto(total, n_threads=nt, workload=pw)
    assert _choice(got.choice) == _choice(want.choice)
    assert _plan(got.plan) == _plan(want.plan)
    assert (got.n_send_parts, got.n_recv_parts, got.part_bytes,
            got.aggr_bytes, got.n_channels) == \
        (want.n_send_parts, want.n_recv_parts, want.part_bytes,
         want.aggr_bytes, want.n_channels)
    assert ppart.PartitionedRequest(8, 8, 1024.0).choice is None


@pytest.fixture(scope="module")
def llama_leaves():
    """llama3.2-1b's leaves at full width without allocation: JAX's
    abstract tree and the port's model on the ``meta`` device."""
    jshapes = jlm.param_shapes(jget("llama3.2-1b"))
    model = plm.LM(pget("llama3.2-1b"), device="meta")
    return jshapes, model


def _buckets(plan):
    return [(b.leaf_ids, b.sizes, b.nbytes, b.channel) for b in plan.buckets]


@pytest.mark.parametrize("aggr,channels", [("auto", "auto"), ("auto", 1),
                                           (1 << 20, "auto")])
def test_bucketing_auto_plan_equals_reference(llama_leaves, aggr, channels):
    jshapes, model = llama_leaves
    want = rb.make_plan(jax.tree.leaves(jshapes), aggr, channels)
    leaves = [segs for _, segs in plm.param_leaves(model.named_parameters())]
    got = pb.make_plan(leaves, aggr, channels)
    assert _buckets(got) == _buckets(want)
    assert got.total_bytes == want.total_bytes
    layer = [segs for _, segs in
             plm.param_leaves(model.layers[0].named_parameters())]
    jlayer = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape[1:],
                                                         s.dtype),
                          jshapes["layers"])
    assert _buckets(pb.make_plan(layer, aggr, channels)) == \
        _buckets(rb.make_plan(jax.tree.leaves(jlayer), aggr, channels))


def _sync(cfg):
    return (cfg.mode, cfg.aggr_bytes, cfg.comm_dtype, cfg.n_channels)


@pytest.mark.parametrize("kw", [
    {}, {"tokens_per_step": 64.0}, {"tokens_per_step": 1e6},
    {"max_channels": 2, "comm_dtype": "bfloat16"},
    {"tokens_per_step": 512.0, "max_channels": 1},
], ids=["default", "few-tokens", "many-tokens", "two-channels", "one-channel"])
def test_auto_sync_config_equals_reference(llama_leaves, kw):
    jshapes, model = llama_leaves
    want = reb.auto_sync_config(jshapes, **kw)
    got = peb.auto_sync_config(model, **kw)
    assert _sync(got) == _sync(want)
    leaves = [segs for _, segs in plm.param_leaves(model.named_parameters())]
    assert _sync(peb.auto_sync_config(leaves, **kw)) == _sync(want)
    assert got.group is None


def test_auto_sync_config_modes_and_cfg():
    """The approach -> mode map over payloads and workloads that pick
    different approaches, leaves given as a list, and a NetConfig
    passed through, against the reference."""
    modes = set()
    for n in (250, 25_000, 4_000_000):
        leaves = [np.zeros((n,), np.float32), np.zeros((3, n), np.float16)]
        tensors = [torch.empty(n), torch.empty((3, n), dtype=torch.float16)]
        for flops in (16.0, 1e5):
            for cfg in (None, pfb.DEFAULT_NET):
                want = reb.auto_sync_config(
                    leaves, workload=rpl.training_workload(flops),
                    cfg=None if cfg is None else rpl.DEFAULT_NET)
                got = peb.auto_sync_config(
                    tensors, workload=ppl.training_workload(flops), cfg=cfg)
                assert _sync(got) == _sync(want), (n, flops, cfg)
                modes.add(got.mode)
    assert {"partitioned", "per_leaf"} <= modes


# ---------------------------------------------------------------------------
# The closed loop on the port's engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ("torch", "cuda"))
def test_autotune_full_grid_reproduces_baseline(engine):
    results = run_spec(SPECS["autotune"], mode="full", engine=engine,
                       device="cpu")
    assert len(results) == len(REF_SPECS["autotune"].points("full")) == 18
    violations = compare_to_baseline(BASELINE, {"autotune": results})
    assert not violations, "\n".join(violations)
    records = BASELINE["specs"]["autotune"]["records"]
    for key, metrics in results.items():
        for name in ("n_messages", "chosen_approach_idx", "chosen_theta",
                     "chosen_aggr_bytes", "chosen_n_vcis", "n_candidates"):
            assert metrics[name] == records[key][name], (key, name)


@pytest.mark.parametrize("params", GRID[::3], ids=pengine.record_key)
def test_run_autotune_equals_reference_runner(params):
    want = rengine.run_autotune(params, engine="reference")
    assert pengine.run_autotune(params, engine="reference",
                                device="cpu") == want
    assert pengine.run_autotune(params, engine="cuda", device="cpu") == want


def test_evaluate_grid_resolves_the_device_first():
    desc = ppl.ScenarioDesc(total_bytes=float(1 << 20), n_threads=4)
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        ppl.evaluate_grid(desc)
    with pytest.raises(RuntimeError, match="cuda"):
        pengine.run_autotune(GRID[0])
    with pytest.raises(ValueError, match="device"):
        ppl.evaluate_grid(desc, device="mps")


def test_autotune_cli_prints_the_reference_rows(capsys):
    from repro_torch import autotune
    assert autotune.main(["--scenario", "n_threads=4,", "--explain",
                          "--top", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    rows = [p for p in GRID if "n_threads=4," in pengine.record_key(p)]
    assert out.count("  pick: ") == len(rows) == 6
    desc = rengine.autotune_desc(rows[0])
    for line in rpl.explain(desc, rpl.rank_plans(desc)[1]).splitlines():
        assert f"  | {line}" in out
    assert autotune.main(["--scenario", "no-such-key", "--device",
                          "cpu"]) == 2


# ---------------------------------------------------------------------------
# The reference's property cases, on the port (tests/test_planner.py)
# ---------------------------------------------------------------------------

SCENARIO = dict(
    total_bytes=st.sampled_from([4096, 64 << 10, 1 << 20, 16 << 20]),
    n_threads=st.sampled_from([1, 2, 4, 8, 16, 32]),
    workload=st.sampled_from((None, ppm.FFT, ppm.STENCIL)),
)


@given(**SCENARIO)
@settings(max_examples=20, deadline=None)
def test_terms_sum_to_prediction(total_bytes, n_threads, workload):
    desc = ppl.ScenarioDesc(total_bytes=float(total_bytes),
                            n_threads=n_threads, workload=workload)
    for choice in ppl.rank_plans(desc):
        total = sum(t for _, t in choice.terms)
        assert math.isclose(total, choice.predicted_s, rel_tol=1e-12)
        assert choice.predicted_s > 0


@given(**SCENARIO)
@settings(max_examples=20, deadline=None)
def test_auto_never_predicts_worse_than_default(total_bytes, n_threads,
                                                workload):
    desc = ppl.ScenarioDesc(total_bytes=float(total_bytes),
                            n_threads=n_threads, workload=workload)
    default = ppl.predict(desc, ppl.default_candidate(desc))
    assert ppl.choose_plan(desc).predicted_s <= default.predicted_s
    part_best = ppl.choose_plan(desc, approaches=("part",))
    assert part_best.predicted_s <= default.predicted_s


def test_choice_is_deterministic_and_compute_theta_invariant():
    desc = ppl.ScenarioDesc(total_bytes=float(1 << 20), n_threads=4,
                            workload=ppm.FFT)
    assert ppl.choose_plan(desc) == ppl.choose_plan(desc)
    times = {desc.compute_seconds(th) for th in (1, 2, 8, 64)}
    assert len({round(t, 18) for t in times}) == 1


def test_unknown_approach_and_invalid_desc_rejected():
    desc = ppl.ScenarioDesc(total_bytes=1024.0)
    with pytest.raises(ValueError):
        ppl.predict(desc, ppl.Candidate("rma_single_passive", 1, 0.0, 1))
    with pytest.raises(ValueError):
        ppl.candidate_grid(desc, approaches=("part", "bogus"))
    with pytest.raises(ValueError):
        ppl.candidate_grid(desc, approaches=())
    with pytest.raises(ValueError):
        ppl.ScenarioDesc(total_bytes=0.0)
    with pytest.raises(ValueError):
        ppl.ScenarioDesc(total_bytes=1.0, n_threads=0)


@pytest.mark.parametrize("kw", [
    dict(total_bytes=float(1 << 20), n_threads=1, max_parts=1, max_vcis=1),
    dict(total_bytes=64.0, n_threads=1, workload=ppm.FFT)],
    ids=["one-partition", "tiny"])
def test_degenerate_scenarios_regret(kw):
    desc = ppl.ScenarioDesc(**kw)
    ev = ppl.evaluate_grid(desc, engine="cuda", device="cpu")
    assert ev.regret <= 1.10
    if kw.get("max_parts") == 1:
        assert ev.choice.theta == 1 and ev.choice.n_vcis == 1


def test_ready_ramp_matches_workload_sampling():
    desc = ppl.ScenarioDesc(total_bytes=float(1 << 20), n_threads=4,
                            workload=ppm.FFT)
    noiseless = ppm.Workload(ai=ppm.FFT.ai, ci=ppm.FFT.ci)
    expect = noiseless.sample_ready(4, 8, desc.part_bytes(8),
                                    np.random.default_rng(0))
    np.testing.assert_allclose(desc.ready(8), expect, rtol=1e-12)


@pytest.mark.parametrize("params", SPECS["autotune"].points("smoke"),
                         ids=lambda p: f"T{p['n_threads']}-{p['workload']}")
def test_smoke_grid_regret_within_10_percent(params):
    metrics = pengine.run_autotune(params, engine="torch", device="cpu")
    assert metrics["regret"] <= 1.10, metrics
    desc = pengine.autotune_desc(params)
    t_default, _ = ppl.simulate_candidate(desc, ppl.default_candidate(desc),
                                          engine="torch", device="cpu")
    assert metrics["auto_time_us"] <= t_default / 1e-6 * 1.10


def test_grid_dedup_keeps_one_per_signature():
    desc = ppl.ScenarioDesc(total_bytes=float(1 << 20), n_threads=4)
    cands = ppl.candidate_grid(desc)
    sigs = [ppl._signature(desc, c) for c in cands]
    assert len(sigs) == len(set(sigs))
    assert all(desc.n_threads * c.theta <= desc.max_parts for c in cands)
    assert all(c.n_vcis <= desc.max_vcis for c in cands)


def test_plan_auto_threading():
    plan, choice = pcp.plan_auto(float(4 << 20), n_threads=4,
                                 workload=ppm.FFT)
    assert choice.approach == "part"
    assert plan.n_items == 4 * choice.theta
    assert plan.n_channels_used <= choice.n_vcis
    plan, _ = pcp.plan_auto(sizes=[100_000.0] * 37)
    assert plan.n_items == 37 and plan.total_bytes == 37 * 100_000.0
    with pytest.raises(ValueError):
        pcp.plan_auto()
    with pytest.raises(ValueError):
        pcp.plan_auto(1024.0, sizes=[1.0])
    req = ppart.PartitionedRequest.auto(float(4 << 20), n_threads=4,
                                        workload=ppm.STENCIL)
    assert req.n_send_parts == 4 * req.choice.theta
    assert req.n_messages == req.plan.n_messages
