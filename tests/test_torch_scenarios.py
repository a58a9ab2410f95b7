"""The paper's evaluation on the port: Figs 4-8, the 1-D halo, steady
state, load imbalance, serving, faults, membership and recovery.

The thirteen specs' full grids run through the port's sweep on the
``torch`` and ``cuda`` engines (on the CPU) and must reproduce
``BENCH_scenarios.json`` with no violation and ``n_messages`` exact;
the two engines' records are equal float for float.  Each new driver
of ``repro_torch`` runs on both engines, with the adaptive cutoffs as
they are and forced to 0 (every batch through the staged scans and the
kernel's plain version), and must equal ``repro``'s driver on
``engine="reference"`` exactly, on the fields of the shared ``DRIVERS``
table.  The host modules the drivers use (``perfmodel``, ``arrivals``,
``faults``, ``recovery``, ``elastic``) are held against the JAX
package's.  Tolerance everywhere: exact.
"""

import json
import pathlib

import numpy as np
import pytest

from _engines import DRIVERS, assert_results_equal
from repro.core import arrivals as rarr
from repro.core import faults as rflt
from repro.core import perfmodel as rpm
from repro.core import recovery as rrec
from repro.core import simulator as rsim
from repro.experiments import SPECS as REF_SPECS
from repro.experiments import contention_crossover as ref_crossover
from repro.experiments import run_spec as ref_run_spec
from repro.runtime import elastic as relastic
from repro_torch.core import arrivals as parr
from repro_torch.core import fabric as pfb
from repro_torch.core import fabric_cuda as pfc
from repro_torch.core import faults as pflt
from repro_torch.core import perfmodel as ppm
from repro_torch.core import recovery as prec
from repro_torch.core import simulator as psim
from repro_torch.experiments import (SPECS, compare_to_baseline,
                                     contention_crossover, run_spec)
from repro_torch.experiments import engine as pengine
from repro_torch.runtime import elastic as pelastic

BASELINE = json.loads((pathlib.Path(__file__).resolve().parent.parent
                       / "BENCH_scenarios.json").read_text())

PORT_ENGINES = ("torch", "cuda")

# The specs this slice brings to the port (155 golden records).
NEW_SPECS = ("fig4_latency", "fig5_contention", "fig6_vci",
             "fig7_aggregation", "fig8_earlybird", "halo1d",
             "steady_state", "imbalance", "serving", "faults",
             "membership", "serving_faults", "recovery")


@pytest.fixture
def forced(monkeypatch):
    """Every port batch through the staged scans / kernels, however
    narrow (the port's own adaptive cutoffs set to 0)."""
    monkeypatch.setattr(pfb, "SCALAR_BATCH_CUTOFF", 0)
    monkeypatch.setattr(pfb, "MIN_GROUP_PARALLELISM", 0)


@pytest.fixture
def scans(monkeypatch):
    """Count the messages of every call of the cuda engine's kernel
    wrapper (its plain version on the CPU)."""
    calls = []
    real = pfc.fabric_scan

    def counting(ops):
        calls.append(ops.n)
        return real(ops)
    monkeypatch.setattr(pfc, "fabric_scan", counting)
    return calls


# ---------------------------------------------------------------------------
# The full grids against the golden baseline
# ---------------------------------------------------------------------------

def _full(name, engine):
    """One spec's full grid on ``engine`` (the run cache keys engine and
    device, so the equality test below reuses these runs)."""
    return run_spec(SPECS[name], mode="full", engine=engine, device="cpu")


@pytest.mark.parametrize("name", NEW_SPECS)
@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_full_grid_reproduces_baseline(engine, name):
    results = _full(name, engine)
    assert len(results) == len(REF_SPECS[name].points("full"))
    violations = compare_to_baseline(BASELINE, {name: results})
    assert not violations, "\n".join(violations)
    records = BASELINE["specs"][name]["records"]
    for key, metrics in results.items():
        assert metrics["n_messages"] == records[key]["n_messages"], key
        assert all(np.isfinite(v) for v in metrics.values()), key


@pytest.mark.parametrize("name", NEW_SPECS)
def test_full_grid_torch_equals_cuda(name):
    assert _full(name, "torch") == _full(name, "cuda")


def test_new_specs_hold_155_records():
    assert set(NEW_SPECS) <= set(SPECS)
    assert sum(len(SPECS[n].points("full")) for n in NEW_SPECS) == 155


@pytest.mark.parametrize("name", ["halo1d", "faults"])
def test_full_grid_reaches_the_kernel_unforced(name, scans):
    """Under the default cutoffs the kernel's wrapper sees halo1d's
    16-rank records and the fault-free records of ``faults`` (a 4x4
    torus), one call each; every other new spec routes around it, as
    the reference routes around its Pallas kernel."""
    pengine._CACHE.clear()
    psim.clear_merge_memo()
    _full(name, "cuda")
    want = {"halo1d": 3, "faults": 3}[name]
    assert len(scans) == want


@pytest.mark.parametrize("name", ["fig4_latency", "fig8_earlybird",
                                  "steady_state", "imbalance", "serving",
                                  "membership"])
def test_full_grid_skips_the_kernel_unforced(name, scans):
    pengine._CACHE.clear()
    _full(name, "cuda")
    assert scans == []


# ---------------------------------------------------------------------------
# Each new driver against the reference's scalar oracle
# ---------------------------------------------------------------------------

MEMBERSHIP_FIELDS = ("iter_times_s", "epoch_starts", "quiesce_s",
                     "replan_s", "warmup_s", "tts_s", "n_messages",
                     "plan_data", "plan_model", "plan_dropped",
                     "grad_accum_factor")


def _membership_faults(pkg, fail_at_us, recover_at_us):
    failures = (pkg.RankFailure(3, t_fail_us=fail_at_us,
                                t_recover_us=recover_at_us),)
    return pkg.FaultSpec(failures=failures)


def _degrade(pkg):
    return pkg.FaultSpec(degradations=(
        pkg.LinkDegrade(t_start_us=2.0, t_end_us=40.0, factor=0.4),
        pkg.LinkDegrade(t_start_us=10.0, t_end_us=30.0, factor=0.5,
                        src=0)))


# (driver, approach, kwargs built per package): the reference and the
# port each get their own FaultSpec objects.
CASES = {
    "oneshot-fig8": ("oneshot", "part", lambda pkg, sim: dict(
        n_threads=4, theta=1, part_bytes=4 << 20,
        ready=sim.delayed_ready(4, 1, 4 << 20, 100.0))),
    "oneshot-rma": ("oneshot", "rma_many_active", lambda pkg, sim: dict(
        n_threads=4, theta=2, part_bytes=8192, n_vcis=2)),
    "steady-part": ("steady", "part", lambda pkg, sim: dict(
        n_iters=6, n_threads=4, theta=8, part_bytes=8192, n_vcis=4,
        aggr_bytes=16384)),
    "steady-many": ("steady", "pt2pt_many", lambda pkg, sim: dict(
        n_iters=3, n_threads=2, theta=4, part_bytes=2048, n_vcis=2,
        ready=sim.delayed_ready(2, 4, 2048, 250.0))),
    "halo-gamma": ("halo", "part", lambda pkg, sim: dict(
        n_ranks=8, theta=4, part_bytes=1 << 20, n_vcis=2,
        ready=sim.delayed_ready(1, 4, 1 << 20, 250.0))),
    "imbalance-stencil": ("imbalance", "part", lambda pkg, sim: dict(
        n_ranks=4, workload=pkg.STENCIL, theta=4, part_bytes=1 << 16,
        n_threads=2, n_vcis=2, seed=1)),
    "imbalance-fft": ("imbalance", "pt2pt_single", lambda pkg, sim: dict(
        n_ranks=3, workload=pkg.FFT, theta=2, part_bytes=1 << 16,
        n_threads=2, seed=4)),
    "serving-tenants": ("serving", "part", lambda pkg, sim: dict(
        arrival="bursty", rate_rps=14000, n_requests=40, n_tenants=4,
        n_stages=4, theta=8, part_bytes=16384, n_vcis=4,
        compute_us=40.0, seed=3)),
    "serving-many": ("serving", "pt2pt_many", lambda pkg, sim: dict(
        arrival="poisson", rate_rps=20000, n_requests=24, n_tenants=2,
        skew=0.5, n_stages=3, theta=4, part_bytes=4096, n_vcis=2,
        compute_us=4.0, seed=1)),
    "serving-rma": ("serving", "rma_single_passive", lambda pkg, sim: dict(
        arrival="poisson", rate_rps=20000, n_requests=12, n_tenants=2,
        n_stages=3, theta=2, part_bytes=4096, n_vcis=2, seed=2)),
    "serving-drops-hedged": ("serving", "part", lambda pkg, sim: dict(
        arrival="poisson", rate_rps=8000, n_requests=32, n_tenants=4,
        skew=0.3, theta=8, part_bytes=16384, n_vcis=4, compute_us=2.0,
        seed=2, policy="hedged",
        faults=pkg.FaultSpec(drop_prob=0.02, timeout_us=150.0, seed=2))),
    "serving-shed": ("serving", "part", lambda pkg, sim: dict(
        arrival="poisson", rate_rps=120000, n_requests=48, n_tenants=2,
        theta=8, part_bytes=32768, n_vcis=2, compute_us=2.0,
        queue_depth=6, deadline_us=300.0)),
    "faulty-clean": ("faulty", "part", lambda pkg, sim: dict(
        faults=pkg.FaultSpec(), dims=(4, 4), theta=8,
        face_bytes=[131072.0] * 2, n_vcis=2)),
    "faulty-drops": ("faulty", "pt2pt_many", lambda pkg, sim: dict(
        faults=pkg.FaultSpec(drop_prob=0.05, timeout_us=50.0, seed=3),
        dims=(3, 2), theta=4, face_bytes=[32768.0] * 2, n_vcis=2)),
    "faulty-adaptive": ("faulty", "part", lambda pkg, sim: dict(
        faults=pkg.FaultSpec(drop_prob=0.05, timeout_us=150.0, seed=3),
        policy="adaptive", dims=(2, 2), theta=8,
        face_bytes=[131072.0] * 2, n_vcis=2)),
    "faulty-degraded": ("faulty", "rma_single_active", lambda pkg, sim: dict(
        faults=_degrade(pkg), dims=(2, 2), theta=4,
        face_bytes=[65536.0] * 2, n_vcis=2)),
    "membership-leave": ("membership", "part", lambda pkg, sim: dict(
        n_ranks=8, model_parallel=2, theta=8, part_bytes=16384,
        faults=_membership_faults(pkg, 60.0, None), n_iters=8, n_vcis=2)),
    "membership-rejoin": ("membership", "pt2pt_single", lambda pkg, sim: dict(
        n_ranks=6, theta=4, part_bytes=65536, target_data=6,
        faults=_membership_faults(pkg, 40.0, 120.0), n_iters=10,
        n_vcis=2)),
}

PORT_DRIVERS = {
    "oneshot": psim.simulate, "steady": psim.simulate_steady_state,
    "halo": psim.simulate_halo, "imbalance": psim.simulate_imbalance,
    "serving": psim.simulate_serving, "faulty": psim.simulate_faulty,
    "membership": psim.simulate_membership}


class _Ref:  # the reference package's modules a case needs
    RankFailure, FaultSpec, LinkDegrade = (rflt.RankFailure, rflt.FaultSpec,
                                           rflt.LinkDegrade)
    FFT, STENCIL = rpm.FFT, rpm.STENCIL


class _Port:
    RankFailure, FaultSpec, LinkDegrade = (pflt.RankFailure, pflt.FaultSpec,
                                           pflt.LinkDegrade)
    FFT, STENCIL = ppm.FFT, ppm.STENCIL


def _reference(case):
    driver, approach, make = CASES[case]
    if driver == "membership":
        return rsim.simulate_membership(approach, engine="reference",
                                        **make(_Ref, rsim))
    return DRIVERS[driver].run(approach, "reference", **make(_Ref, rsim))


def _fields(driver):
    return MEMBERSHIP_FIELDS if driver == "membership" \
        else DRIVERS[driver].fields


def _check_case(case, engine):
    driver, approach, make = CASES[case]
    want = _reference(case)
    got = PORT_DRIVERS[driver](approach, engine=engine, device="cpu",
                               **make(_Port, psim))
    assert_results_equal(want, got, _fields(driver),
                         context=f"[{case}/{engine}] ")
    return got


@pytest.mark.parametrize("engine", PORT_ENGINES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_driver_matches_reference(case, engine):
    _check_case(case, engine)


# With the cutoffs at 0 the cuda engine's kernel wrapper sees every
# batched driver's traffic.  It never sees a single flow (``oneshot``,
# ``steady``: the scalar path on every engine), dependent RMA traffic,
# or a run on the NumPy faulty fabric (drops or degraded links), as in
# the reference.
SCALAR_CASES = ("oneshot-fig8", "oneshot-rma", "steady-part", "steady-many",
                "serving-rma", "serving-drops-hedged", "faulty-drops",
                "faulty-adaptive", "faulty-degraded")


@pytest.mark.parametrize("engine", PORT_ENGINES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_driver_matches_reference_forced(case, engine, forced, scans):
    _check_case(case, engine)
    if case in SCALAR_CASES:
        assert scans == []
    elif engine == "cuda":
        assert scans, f"{case}: the kernel's wrapper was never called"


def test_serving_warm_owners_across_waves(forced, scans):
    """Serving stamps ``thread = tenant`` and offsets the VCI by it, so
    each bank's owner changes from wave to wave; the cuda engine's
    carried owners (set from the host grouping) must keep every wave
    exact, and the waves must really reach the kernel's wrapper."""
    got = _check_case("serving-tenants", "cuda")
    assert len(scans) == got.n_waves


def test_membership_builds_a_cold_fabric_per_epoch(forced, scans):
    got = _check_case("membership-rejoin", "cuda")
    assert len(got.epoch_starts) == 3
    assert len(scans) == got.n_iters  # one batch per ring iteration


def test_faulty_with_drops_runs_on_the_numpy_fabric():
    kw = dict(dims=(2, 2), theta=4, face_bytes=[8192.0] * 2)
    spec = pflt.FaultSpec(drop_prob=0.1, seed=1)
    fab = pflt.make_faulty_fabric("cuda", psim.DEFAULT_NET, 2, 4, spec,
                                  device="cpu")
    assert type(fab) is pflt.FaultyFabric
    r = psim.simulate_faulty("part", faults=spec, engine="cuda",
                             device="cpu", **kw)
    assert r.n_messages == r.n_delivered + r.n_retransmits
    assert np.all(r.arrival_s >= r.submit_s)


# ---------------------------------------------------------------------------
# The host modules against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,theta,gamma", [
    (8, 1, 1.0), (8, 1, 10.0), (8, 8, 1000.0), (4, 1, 100.0),
    (32, 4, 250.0)])
def test_perfmodel_gain_equations(n, theta, gamma):
    beta = ppm.MELUXINA_BETA
    assert ppm.eta_large(n, theta, gamma, beta) == \
        rpm.eta_large(n, theta, gamma, beta)
    assert ppm.eta_small(n, theta) == rpm.eta_small(n, theta)
    s = 1 << 20
    delay = gamma * ppm.US_PER_MB_TO_S_PER_B * s
    assert ppm.bulk_time(n * theta, s, beta) == \
        rpm.bulk_time(n * theta, s, beta)
    assert ppm.pipelined_time(n * theta, s, beta, delay) == \
        rpm.pipelined_time(n * theta, s, beta, delay)
    assert ppm.breakeven_partition_bytes(n, theta, gamma, beta, 1.22e-6) \
        == rpm.breakeven_partition_bytes(n, theta, gamma, beta, 1.22e-6)


@pytest.mark.parametrize("name", ["fft", "stencil"])
def test_perfmodel_workloads(name):
    p, r = ppm.WORKLOADS[name], rpm.WORKLOADS[name]
    assert p == ppm.Workload(ai=r.ai, ci=r.ci, eps=r.eps, delta=r.delta,
                             freq_hz=r.freq_hz)
    assert p.mu_us_per_mb == r.mu_us_per_mb
    for theta in (1, 2, 8):
        assert p.gamma(theta) == r.gamma(theta)
        assert p.delay_seconds(theta, 65536.0) == \
            r.delay_seconds(theta, 65536.0)
        for beta in (ppm.MELUXINA_BETA, ppm.STENCIL_EXAMPLE_BETA):
            assert p.eta(8, theta, beta) == r.eta(8, theta, beta)
    got = p.sample_ready(4, 8, 1 << 20, np.random.default_rng(7))
    want = r.sample_ready(4, 8, 1 << 20, np.random.default_rng(7))
    assert np.array_equal(got, want)
    assert np.array_equal(psim.sampled_ready(p, 2, 4, 4096.0, seed=3),
                          rsim.sampled_ready(r, 2, 4, 4096.0, seed=3))


def test_perfmodel_constants_and_paper_examples():
    assert (ppm.MELUXINA_BETA, ppm.MELUXINA_LATENCY,
            ppm.STENCIL_EXAMPLE_BETA) == (rpm.MELUXINA_BETA,
                                          rpm.MELUXINA_LATENCY,
                                          rpm.STENCIL_EXAMPLE_BETA)
    # the reference's TPU model inputs, which the port's planner needs
    for name in ("TPU_ICI_BETA", "TPU_HBM_BETA", "TPU_PEAK_FLOPS",
                 "TPU_DCN_BETA"):
        assert getattr(ppm, name) == getattr(rpm, name), name
    assert ppm.FFT.gamma(8) == pytest.approx(1263.67, abs=0.5)
    assert ppm.STENCIL.eta(8, 1, ppm.STENCIL_EXAMPLE_BETA) == \
        pytest.approx(1.1060, abs=2e-4)


@pytest.mark.parametrize("model", ["poisson", "bursty"])
@pytest.mark.parametrize("n_tenants,skew", [(1, 0.0), (4, 0.0), (4, 1.0),
                                            (3, 0.5)])
@pytest.mark.parametrize("seed", [0, 3])
def test_make_trace_bitwise(model, n_tenants, skew, seed):
    got = parr.make_trace(model, 14000.0, 96, n_tenants=n_tenants,
                          skew=skew, seed=seed, t0=1e-6)
    want = rarr.make_trace(model, 14000.0, 96, n_tenants=n_tenants,
                           skew=skew, seed=seed, t0=1e-6)
    assert np.array_equal(got.t, want.t)
    assert np.array_equal(got.tenant, want.tenant)
    assert got.offered_rps == want.offered_rps


def test_drop_draws_and_expected_retransmissions():
    kw = dict(drop_prob=0.05, timeout_us=80.0, backoff=1.5, max_retries=5,
              seed=11)
    p, r = pflt.FaultSpec(**kw), rflt.FaultSpec(**kw)
    pd, rd = pflt.DropDraws(p, 300, extra=(4,)), rflt.DropDraws(r, 300,
                                                               extra=(4,))
    assert np.array_equal(pd.u, rd.u)
    msgs = [(16384.0, 1.0, 64.0), (131072.0, 8.0, 4.0), (0.0, 0.0, 2.0)]
    for kind in prec.POLICIES:
        assert pflt.expected_retrans_s(
            msgs, p, psim.DEFAULT_NET, prec.RecoveryPolicy(kind)) == \
            rflt.expected_retrans_s(msgs, r, rsim.DEFAULT_NET,
                                    rrec.RecoveryPolicy(kind))
    t = np.linspace(0.0, 50e-6, 7)
    src, dst = np.arange(7) % 2, (np.arange(7) + 1) % 2
    deg = _degrade(_Port)
    assert np.array_equal(deg.wire_factor_array(src, dst, t),
                          _degrade(_Ref).wire_factor_array(src, dst, t))


@pytest.mark.parametrize("kind", ["fixed", "adaptive", "hedged"])
def test_recovery_policies_bitwise(kind):
    rng = np.random.default_rng(5)
    states = [pkg.RecoveryPolicy(kind).fresh(50.0, 2.0)
              for pkg in (prec, rrec)]
    for attempt in range(3):
        src, dst = rng.integers(0, 3, 20), rng.integers(0, 3, 20)
        t_sub = rng.uniform(0, 1e-4, 20)
        t_arr = t_sub + rng.uniform(1e-6, 5e-5, 20)
        nb = rng.choice([4096.0, 65536.0], 20)
        ok = rng.random(20) > 0.2
        outs = []
        for st in states:
            st.observe(src, dst, t_sub, t_arr, nb, attempt, ok)
            outs.append(st.retrans_times(src[~ok], dst[~ok], t_sub[~ok],
                                         t_arr[~ok], attempt))
        assert np.array_equal(outs[0], outs[1])
    a, b = states
    assert (a.n_hedges, a.n_suppressed, a.duplicate_bytes) == \
        (b.n_hedges, b.n_suppressed, b.duplicate_bytes)
    assert (prec.DEFAULT_TIMEOUT_US, prec.DEFAULT_BACKOFF,
            prec.DEFAULT_MAX_RETRIES) == (rrec.DEFAULT_TIMEOUT_US,
                                          rrec.DEFAULT_BACKOFF,
                                          rrec.DEFAULT_MAX_RETRIES)


@pytest.mark.parametrize("n,model,target", [(8, 2, None), (7, 2, 4),
                                            (5, 1, None), (9, 4, 3)])
def test_plan_mesh_matches_reference(n, model, target):
    p = pelastic.plan_mesh(n, model, target_data=target)
    r = relastic.plan_mesh(n, model, target_data=target)
    assert (p.data, p.model, p.dropped_devices, p.grad_accum_factor,
            p.n_devices) == (r.data, r.model, r.dropped_devices,
                             r.grad_accum_factor, r.n_devices)
    with pytest.raises(ValueError):
        pelastic.plan_mesh(1, 2)


def test_make_faulty_fabric_routing():
    spec = pflt.FaultSpec(drop_prob=0.1)
    cfg = psim.DEFAULT_NET
    for engine in ("vector", "torch", "cuda"):
        fab = pflt.make_faulty_fabric(engine, cfg, 2, 4, spec,
                                      device="cpu")
        assert type(fab) is pflt.FaultyFabric
    fab = pflt.make_faulty_fabric("reference", cfg, 2, 4, spec,
                                  device="cpu")
    assert type(fab) is pflt.FaultyReferenceFabric
    with pytest.raises(ValueError, match="unknown engine"):
        pflt.make_faulty_fabric("pallas", cfg, 2, 4, spec, device="cpu")


def test_theoretical_time_and_sweep_sizes():
    assert psim.theoretical_time(1 << 20) == rsim.theoretical_time(1 << 20)
    kw = dict(n_threads=2, theta=4)
    got = psim.sweep_sizes("part", [4096, 1 << 20], engine="cuda",
                           device="cpu", **kw)
    want = rsim.sweep_sizes("part", [4096, 1 << 20], engine="reference",
                            **kw)
    for s in want:
        assert_results_equal(want[s], got[s], DRIVERS["oneshot"].fields)
    assert np.array_equal(psim.delayed_ready(4, 2, 1e6, 100.0),
                          rsim.delayed_ready(4, 2, 1e6, 100.0))


# ---------------------------------------------------------------------------
# The Fig-5/Fig-6 crossover
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["smoke", "full"])
def test_crossover_equals_reference(mode):
    got = contention_crossover(
        {"fig6_vci": run_spec(SPECS["fig6_vci"], mode=mode, engine="cuda",
                              device="cpu")})
    want = ref_crossover(
        {"fig6_vci": ref_run_spec(REF_SPECS["fig6_vci"], mode=mode)})
    assert got == want
    for ap in ("part", "pt2pt_many"):
        assert got[ap]["slowdown_at_1_vcis"] > 10.0
        assert (got[ap]["slowdown_at_1_vcis"]
                / got[ap]["slowdown_at_32_vcis"]) > 10.0
    assert got["pt2pt_many"]["slowdown_at_32_vcis"] < 1.5
    assert got["part"]["slowdown_at_32_vcis"] < 6.0
    assert contention_crossover({}) == {}
