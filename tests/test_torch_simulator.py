"""The port's scenario drivers against the JAX package's scalar oracle.

``simulate``, ``simulate_halo`` and ``simulate_stencil`` of
``repro_torch`` run every registered approach on the ``torch`` and
``cuda`` engines (on the CPU, forced through the staged paths) and must
reproduce ``repro``'s drivers on ``engine="reference"`` exactly, on the
comparison fields of the shared ``DRIVERS`` table.  The whole-grid path
``simulate_stencil_grid`` is held against ``repro``'s ``pallas`` grid
(x64, interpret mode).
"""

import numpy as np
import pytest
import torch

from _engines import DRIVERS, assert_results_equal, ready
from repro.core import simulator as rsim
from repro_torch.core import fabric as pfb
from repro_torch.core import fabric_cuda as pfc
from repro_torch.core import simulator as psim

PORT_ENGINES = ("torch", "cuda")


@pytest.fixture
def forced(monkeypatch):
    """Every port batch through the staged scans / kernels, however
    narrow (the port's own adaptive cutoffs set to 0)."""
    monkeypatch.setattr(pfb, "SCALAR_BATCH_CUTOFF", 0)
    monkeypatch.setattr(pfb, "MIN_GROUP_PARALLELISM", 0)


PORT_DRIVERS = {"oneshot": psim.simulate, "halo": psim.simulate_halo,
                "stencil": psim.simulate_stencil}


def assert_port_matches_reference(driver, approach, **kw):
    want = DRIVERS[driver].run(approach, "reference", **kw)
    for engine in PORT_ENGINES:
        got = PORT_DRIVERS[driver](approach, engine=engine, device="cpu",
                                   **kw)
        assert_results_equal(want, got, DRIVERS[driver].fields,
                             context=f"[{driver}/{approach}/{engine}] ")


def test_port_registers_the_same_schedules():
    assert psim.APPROACHES == rsim.APPROACHES
    assert psim.ENGINES == ("vector", "reference", "torch", "cuda")


@pytest.mark.parametrize("dims,n_threads,theta,n_vcis,seed", [
    ((2, 2), 1, 2, 1, 0), ((2, 2, 2), 2, 4, 2, 1), ((3, 2), 2, 2, 2, 2)])
@pytest.mark.parametrize("approach", sorted(psim.APPROACHES))
def test_stencil_all_approaches(approach, dims, n_threads, theta, n_vcis,
                                seed, forced):
    assert_port_matches_reference(
        "stencil", approach, dims=dims, theta=theta, n_threads=n_threads,
        n_vcis=n_vcis, local_shape=(24, 8, 4)[:len(dims)],
        ready=ready(n_threads, theta, seed))


@pytest.mark.parametrize("approach", sorted(psim.APPROACHES))
def test_halo_all_approaches(approach, forced):
    assert_port_matches_reference(
        "halo", approach, n_ranks=4, theta=4, part_bytes=4096, n_threads=2,
        n_vcis=2, ready=ready(2, 4, 3))


@pytest.mark.parametrize("approach", sorted(psim.APPROACHES))
def test_oneshot_all_approaches(approach, forced):
    assert_port_matches_reference(
        "oneshot", approach, n_threads=2, theta=4, part_bytes=2048,
        n_vcis=2, ready=ready(2, 4, 5))


def test_per_rank_ready_tables(forced):
    """Per-rank ready tables (one intent class per flow) on a 3x2 grid."""
    rng = np.random.default_rng(9)
    assert_port_matches_reference(
        "stencil", "part", dims=(3, 2), theta=2, n_threads=2, n_vcis=2,
        local_shape=(24, 8), ready=rng.uniform(0.0, 25e-6, size=(6, 2, 2)))


def test_wide_stencil_takes_kernel_path_unforced(monkeypatch):
    """A 512-rank torus reaches the cuda engine's kernel wrapper through
    the normal adaptive routing and matches the reference's vector
    engine exactly."""
    calls = []
    real = pfc.fabric_scan

    def counting(ops):
        calls.append(ops.n)
        return real(ops)
    monkeypatch.setattr(pfc, "fabric_scan", counting)
    kw = dict(dims=(8, 8, 8), theta=4, n_threads=2, n_vcis=2,
              local_shape=(64, 64, 64))
    want = rsim.simulate_stencil("part", engine="vector", **kw)
    got = psim.simulate_stencil("part", engine="cuda", device="cpu", **kw)
    assert calls == [want.n_messages]
    assert_results_equal(want, got, DRIVERS["stencil"].fields)


GRID_POINTS = [dict(approach=ap, dims=d, theta=4, n_threads=2, n_vcis=2,
                    local_shape=(64, 64, 64), bytes_per_cell=8.0)
               for ap in ("pt2pt_single", "part", "pt2pt_many", "part_old",
                          "rma_many_passive", "rma_single_active")
               for d in ((2, 2, 2), (3, 2, 2))]


@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_stencil_grid_matches_pallas_grid(engine):
    jax = pytest.importorskip("jax")  # noqa: F841
    from repro import compat
    from repro.kernels import runtime as rrt
    with compat.x64_mode(True), rrt.force_interpret(True):
        want = rsim.simulate_stencil_grid(GRID_POINTS, engine="pallas")
    got = psim.simulate_stencil_grid(GRID_POINTS, engine=engine,
                                     device="cpu")
    for p, w, g in zip(GRID_POINTS, want, got):
        if p["approach"].startswith("rma_"):
            assert w is None and g is None
            continue
        assert_results_equal(w, g, DRIVERS["stencil"].fields,
                             context=f"[grid/{p['approach']}] ")


def test_stencil_grid_rejects_unknown_engine():
    with pytest.raises(ValueError, match="grid engine"):
        psim.simulate_stencil_grid(GRID_POINTS[:1], engine="vector",
                                   device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    kw = dict(dims=(2, 2), theta=2, local_shape=(8, 8))
    with pytest.raises(RuntimeError, match="cuda"):
        psim.simulate_stencil("part", **kw)
    with pytest.raises(RuntimeError, match="cuda"):
        psim.simulate_stencil_grid([dict(approach="part", **kw)])
    with pytest.raises(RuntimeError, match="cuda"):
        psim.simulate("part", n_threads=1, theta=1, part_bytes=64.0)
