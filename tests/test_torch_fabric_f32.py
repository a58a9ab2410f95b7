"""The float32 mode of the port's torch and cuda fabric engines.

``repro_torch.compat.x64_mode(False)`` runs the engines in single
precision, as ``repro.compat.x64_mode(False)`` runs the JAX package's
``jax`` and ``pallas`` engines (Pallas in interpret mode, as
``tests/test_engine_pallas.py`` runs it on the CPU).  Both sides get
the same stencil points and seeded ready tables; each is held to the
float64 ``ReferenceFabric`` within ``F32_RTOL`` (``tests/_engines.py``)
and to the other within the same tolerance, with ``n_messages`` and
``sent_per_rank`` exact, over the whole-grid path (finish and arrivals
modes), a hypothesis-randomized stencil with every batch forced through
the staged scans and the kernel, and the warm steady-state path.  A
float64 run after a float32 run in the same process is bitwise equal to
the oracle again (the operand memos are keyed by the mode).  The float32
plain version's two arithmetic paths (torch steps and NumPy ``float32``
scalars on the host) give the same bits; the float32 kernel is held
bitwise against that plain version on the card by the ``gpu``-marked
tests of ``tests/test_torch_fabric_f32_kernel.py`` (no JAX there).
"""

import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from _engines import F32_RTOL, PIPELINED, forced_scans as ref_forced, \
    ready  # noqa: E402
from repro import compat as rcompat  # noqa: E402
from repro.core import simulator as rsim  # noqa: E402
from repro.kernels import runtime as rrt  # noqa: E402
from repro_torch import compat  # noqa: E402
from repro_torch import sweep  # noqa: E402
from repro_torch.core import fabric as pfb  # noqa: E402
from repro_torch.core import fabric_cuda as pfc  # noqa: E402
from repro_torch.core import fabric_torch as pft  # noqa: E402
from repro_torch.core import simulator as psim  # noqa: E402
from repro_torch.core import state  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # env without hypothesis: deterministic fallback
    from _hypo import given, settings, st

ENGINES = ("torch", "cuda")
JAX_ENGINES = {"torch": "jax", "cuda": "pallas"}
POINTS = [dict(approach=ap, dims=d, theta=4, n_threads=2, n_vcis=2,
               local_shape=(64, 64, 64), bytes_per_cell=8.0)
          for ap in ("pt2pt_single", "part", "pt2pt_many")
          for d in ((2, 2, 2), (3, 2, 2))]


@contextlib.contextmanager
def jax_f32():
    """The JAX package's engines as its own float32 tests run them."""
    with rcompat.x64_mode(False), rrt.force_interpret(True):
        yield


@contextlib.contextmanager
def port_forced():
    """Every port batch through the staged scans / kernel."""
    cut, par = pfb.SCALAR_BATCH_CUTOFF, pfb.MIN_GROUP_PARALLELISM
    pfb.SCALAR_BATCH_CUTOFF = pfb.MIN_GROUP_PARALLELISM = 0
    try:
        yield
    finally:
        pfb.SCALAR_BATCH_CUTOFF, pfb.MIN_GROUP_PARALLELISM = cut, par


def assert_close(got, want, fields=("rank_tts_s",)):
    """The float32 contract: counters exact, times within F32_RTOL of
    the result's time-to-solution."""
    assert got.n_messages == want.n_messages
    for f in ("sent_per_rank",):
        if hasattr(want, f):
            assert getattr(got, f) == getattr(want, f)
    scale = abs(want.tts_s)
    assert abs(got.tts_s - want.tts_s) <= F32_RTOL * scale
    assert abs(got.time_s - want.time_s) <= F32_RTOL * scale
    for f in fields:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=F32_RTOL * scale)


@pytest.fixture(scope="module")
def oracle():
    return [psim.simulate_stencil(engine="reference", device="cpu", **p)
            for p in POINTS]


def test_default_mode_is_float64_and_the_switch_restores():
    assert compat.x64_enabled() and pft.float_dtype() == torch.float64
    with compat.x64_mode(False):
        assert not compat.x64_enabled()
        assert pft.float_dtype() == torch.float32
        with compat.x64_mode(True):
            assert pft.float_dtype() == torch.float64
        assert not compat.x64_enabled()
    with pytest.raises(KeyError):
        with compat.x64_mode(False):
            raise KeyError("restored on the way out")
    assert compat.x64_enabled()


@pytest.mark.parametrize("engine", ENGINES)
def test_grid_path_matches_jax_and_oracle(engine, oracle):
    with jax_f32():
        want = rsim.simulate_stencil_grid(POINTS, engine=JAX_ENGINES[engine])
    with compat.x64_mode(False):
        got = psim.simulate_stencil_grid(POINTS, engine=engine, device="cpu")
    for g, w, o in zip(got, want, oracle):
        assert g is not None and w is not None
        assert_close(g, o)
        assert_close(w, o)
        assert_close(g, w)
        assert g.face_bytes == o.face_bytes


def test_grid_arrivals_mode_matches_jax(oracle):
    """The kernel's arrivals output (points without an affine finish)
    in float32, against the Pallas kernel's, per message."""
    from repro.core import fabric_pallas as rfp
    from test_torch_fabric_kernel import stencil_items
    ref_items, _, items, _ = stencil_items(POINTS)
    with jax_f32():
        want = rfp.transmit_grid(ref_items)
    with compat.x64_mode(False):
        got = pfc.transmit_grid(items, device="cpu")
    exact = pfc.transmit_grid(items, device="cpu")
    for g, w, e in zip(got, want, exact):
        assert g.dtype == np.float64
        scale = float(np.max(e))
        np.testing.assert_allclose(g, e, rtol=0, atol=F32_RTOL * scale)
        np.testing.assert_allclose(g, np.asarray(w, np.float64), rtol=0,
                                   atol=F32_RTOL * scale)


@given(ap=st.sampled_from(PIPELINED),
       dims=st.sampled_from([(3, 2), (2, 2, 2)]),
       theta=st.sampled_from([2, 4]), seed=st.integers(0, 2))
@settings(max_examples=8, deadline=None)
def test_stencil_randomized_forced(ap, dims, theta, seed):
    """Randomized stencils with every batch through the staged scans
    and the kernel's plain version, float32 on both sides."""
    kw = dict(dims=dims, theta=theta, n_threads=2, n_vcis=2,
              local_shape=(24, 8, 4)[:len(dims)], ready=ready(2, theta, seed))
    oracle = psim.simulate_stencil(ap, engine="reference", device="cpu", **kw)
    with jax_f32(), ref_forced():
        want = rsim.simulate_stencil(ap, engine="pallas", **kw)
    assert_close(want, oracle)
    for engine in ENGINES:
        with compat.x64_mode(False), port_forced():
            got = psim.simulate_stencil(ap, engine=engine, device="cpu", **kw)
        assert_close(got, oracle)
        assert_close(got, want)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("ap", PIPELINED[:2])
def test_halo_warm_path(engine, ap):
    """The warm per-batch path (the fabric's VCI, NIC and wire clocks
    carried in and out of every batch) in float32, forced through the
    scans / kernel."""
    kw = dict(n_ranks=16, theta=4, part_bytes=4096, n_threads=2, n_vcis=2,
              ready=ready(2, 4, 5))
    oracle = psim.simulate_halo(ap, engine="reference", device="cpu", **kw)
    with compat.x64_mode(False), port_forced():
        got = psim.simulate_halo(ap, engine=engine, device="cpu", **kw)
    assert got.rank_tts_s != oracle.rank_tts_s  # float32 did run
    assert_close(got, oracle)


@pytest.mark.parametrize("engine", ENGINES)
def test_float64_after_float32_is_bitwise(engine, oracle):
    """Grid and warm paths: float64, then float32, then float64 again
    in one process; both float64 passes equal the oracle bit for bit,
    and the float32 pass's operands are float32."""
    kw = dict(dims=(2, 2, 2), theta=4, n_threads=2, n_vcis=2,
              local_shape=(24, 8, 4), ready=ready(2, 4, 11))
    warm_oracle = psim.simulate_stencil("part", engine="reference",
                                        device="cpu", **kw)

    def run():
        grid = psim.simulate_stencil_grid(POINTS, engine=engine,
                                          device="cpu")
        with port_forced():
            warm = psim.simulate_stencil("part", engine=engine,
                                         device="cpu", **kw)
        return grid, warm
    first = run()
    with compat.x64_mode(False):
        f32 = run()
    again = run()
    for grid, warm in (first, again):
        for g, o in zip(grid, oracle):
            assert g.rank_tts_s == o.rank_tts_s and g.tts_s == o.tts_s
        assert warm.rank_tts_s == warm_oracle.rank_tts_s
    assert f32[0][0].rank_tts_s != oracle[0].rank_tts_s
    for g, o in zip(f32[0], oracle):
        assert_close(g, o)


def test_memo_keys_carry_the_mode():
    pfc.clear_memos()
    items = [e[2] for e in psim._grid_entries(POINTS[:2])]
    fins = None
    with compat.x64_mode(False):
        ops32, _ = pfc.grid_ops(items, fins, device="cpu")
    ops64, _ = pfc.grid_ops(items, fins, device="cpu")
    assert ops32.t_ready.dtype == torch.float32
    assert ops64.t_ready.dtype == torch.float64
    assert pfc.memo_stats()["grid_ops"]["misses"] == 2
    with compat.x64_mode(False):
        again, _ = pfc.grid_ops(items, fins, device="cpu")
    assert again is ops32
    pfc.clear_memos()


def random_ops(seed, finish, lone_records=None):
    """A float32 super-batch of random traffic (ragged depths)."""
    from test_torch_fabric_kernel import random_traffic
    cols, fin, n_ranks = random_traffic(seed, silent=3)
    item = state.grid_item_from_arrays(**cols, cfg=pfb.DEFAULT_NET, n_vcis=3,
                                       n_ranks=n_ranks)
    spec = pfc.FinishSpec(fid=fin["fid"], foff=fin["foff"],
                          fdst=fin["fdst"], n_ranks=n_ranks)
    with compat.x64_mode(False):
        ops, aux = pfc._assemble([item], [spec] if finish else None)
        return pfc._upload(ops, torch.device("cpu"))


@pytest.mark.parametrize("finish", [True, False])
def test_plain_version_host_walk_equals_torch_steps(finish, monkeypatch):
    """The float32 plain version walks lone records on NumPy float32
    scalars and the rest as torch steps: both give the same bits
    (every record through either path)."""
    ops = random_ops(3, finish)
    assert ops.t_ready.dtype == torch.float32
    assert ops.alpha_nic == float(np.float32(pfb.DEFAULT_NET.alpha_nic))
    monkeypatch.setattr(pfc, "LONE_RECORDS", 0)
    steps = pfc.fabric_scan_ref(ops)
    monkeypatch.setattr(pfc, "LONE_RECORDS", 10 ** 6)
    host = pfc.fabric_scan_ref(ops)
    steps = steps if isinstance(steps, tuple) else (steps,)
    host = host if isinstance(host, tuple) else (host,)
    for a, b in zip(steps, host):
        assert a.dtype == torch.float32
        assert torch.equal(a, b)


def test_kernel_source_has_the_float32_build():
    src = (Path(pfc.__file__).resolve().parents[1] / "csrc"
           / "fabric_scan.cu").read_text()
    for name in pfc.ENTRY.values():
        assert f"int {name}(void* stream" in src
    assert "__fadd_rn" in src and "__dadd_rn" in src
    assert "red.global.max.u32" in src and "red.global.max.u64" in src
    assert "smem_slots) * sizeof(T)" in src


def test_bench_document_records_the_mode():
    doc = {"device": "cpu", "entries": []}
    assert sweep.check_bench_regression(dict(doc, x64=True), doc) == []
    with pytest.raises(ValueError, match="x64"):
        sweep.check_bench_regression(dict(doc, x64=False), doc)
    with pytest.raises(ValueError, match="x64"):
        sweep.check_bench_regression(dict(doc, x64=True),
                                     dict(doc, x64=False))
    spec = [sweep.SPECS["halo1d"]]
    with compat.x64_mode(False):
        got = sweep.run_bench_engine(spec, "smoke", engines=("cuda",),
                                     device="cpu", repeats=1)
    assert got["x64"] is False
