"""The port's fabric engines against the JAX package's scalar oracle.

Random traffic batches (columns drawn from numpy seeds) go through the
reference's ``ReferenceFabric`` and through the port's four engines —
``ReferenceFabric``, ``Fabric``, ``TorchFabric`` and ``CudaFabric``, the
latter two on the CPU (``CudaFabric`` then runs the kernel's plain
version), all forced past the adaptive scalar cutoffs.  Arrivals and the
fabric's warm state must be equal bit for bit in float64.  A second,
warm batch starts every port engine from the reference fabric's state,
moved through ``repro_torch.core.state``.  The one ``gpu`` test runs the
hand-written kernel on the card against its plain version; it needs no
JAX, so it runs on the GPU machine.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import fabric as rfb
from repro_torch.core import fabric as pfb
from repro_torch.core import fabric_cuda as pfc
from repro_torch.core import fabric_torch as pft
from repro_torch.core import simulator as psim
from repro_torch.core import state

ENGINES = {
    "reference": lambda cfg, v, r: pfb.ReferenceFabric(cfg, v, n_ranks=r),
    "vector": lambda cfg, v, r: pfb.Fabric(cfg, v, n_ranks=r),
    "torch": lambda cfg, v, r: pft.TorchFabric(cfg, v, n_ranks=r,
                                               device="cpu"),
    "cuda": lambda cfg, v, r: pfc.CudaFabric(cfg, v, n_ranks=r,
                                             device="cpu"),
}

# A cost configuration off the defaults, so the port must carry it.
REF_CFG = rfb.NetConfig(beta=20e9, alpha_msg=0.12e-6, chi_switch=2.2e-6,
                        eager_max=2048)


@pytest.fixture
def forced(monkeypatch):
    """Every port batch through the staged scans / kernels, however
    narrow (the port's own adaptive cutoffs set to 0)."""
    monkeypatch.setattr(pfb, "SCALAR_BATCH_CUTOFF", 0)
    monkeypatch.setattr(pfb, "MIN_GROUP_PARALLELISM", 0)


def random_batch(seed, n_ranks=6, n=160, t0=0.0):
    """Merge-ordered wire messages with every protocol and cost path:
    eager, bcopy and rendezvous sizes, puts, AM copies, several
    threads per VCI bank."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_ranks, size=n)
    dst = (src + rng.integers(1, n_ranks, size=n)) % n_ranks
    return dict(
        t_ready=np.sort(t0 + rng.uniform(0.0, 20e-6, size=n)),
        nbytes=rng.choice([64.0, 1500.0, 4096.0, 8192.0, 65536.0], size=n),
        vci=rng.integers(0, 7, size=n), thread=rng.integers(0, 3, size=n),
        put=rng.random(n) < 0.3, am_copy=rng.random(n) < 0.1,
        src=src, dst=dst)


def columns(b):
    return (b["t_ready"], b["nbytes"], b["vci"], b["thread"], b["put"],
            b["am_copy"], b["src"], b["dst"])


def reference_run(fab, b):
    """The reference's scalar oracle, one transmit per message."""
    return rfb.ReferenceFabric.advance(fab, *columns(b))


def assert_state_equal(a, b):
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert np.array_equal(a[key], b[key]), key
        else:
            assert a[key] == b[key], key


def test_netconfig_round_trip():
    cfg = state.netconfig_from_dict(dataclasses.asdict(REF_CFG))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(REF_CFG)
    with pytest.raises(ValueError, match="unknown"):
        state.netconfig_from_dict({**dataclasses.asdict(REF_CFG), "x": 1})


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_cold_and_warm_batches_match_reference(engine, seed, forced):
    n_ranks, n_vcis = 6, 3
    cfg = state.netconfig_from_dict(dataclasses.asdict(REF_CFG))
    b1 = random_batch(seed, n_ranks)
    b2 = random_batch(seed + 100, n_ranks, t0=5e-6)
    ref = rfb.ReferenceFabric(REF_CFG, n_vcis, n_ranks=n_ranks)
    port = ENGINES[engine](cfg, n_vcis, n_ranks)
    assert np.array_equal(reference_run(ref, b1), port.advance(*columns(b1)))
    assert_state_equal(state.fabric_state(ref), state.fabric_state(port))
    # a fresh port fabric, warm from the reference's state
    warm = ENGINES[engine](cfg, n_vcis, n_ranks)
    state.load_fabric_state(warm, state.fabric_state(ref))
    assert np.array_equal(reference_run(ref, b2), warm.advance(*columns(b2)))
    assert_state_equal(state.fabric_state(ref), state.fabric_state(warm))


@pytest.mark.parametrize("engine", ["vector", "torch", "cuda"])
def test_wide_batch_unforced(engine):
    """A batch wide enough for the adaptive routing to pick the staged
    path on its own still equals the oracle."""
    b = random_batch(7, n_ranks=64, n=3000)
    ref = rfb.ReferenceFabric(REF_CFG, 4, n_ranks=64)
    port = ENGINES[engine](state.netconfig_from_dict(
        dataclasses.asdict(REF_CFG)), 4, 64)
    assert np.array_equal(reference_run(ref, b),
                          port.transmit_arrays(*columns(b)))
    assert_state_equal(state.fabric_state(ref), state.fabric_state(port))


def test_narrow_batch_takes_scalar_fallback(monkeypatch):
    """Below the adaptive cutoffs CudaFabric launches nothing."""
    def boom(ops):
        raise AssertionError("fabric_scan called for a narrow batch")
    monkeypatch.setattr(pfc, "fabric_scan", boom)
    b = random_batch(3, n=6)
    ref = rfb.ReferenceFabric(REF_CFG, 2, n_ranks=6)
    port = pfc.CudaFabric(state.netconfig_from_dict(
        dataclasses.asdict(REF_CFG)), 2, n_ranks=6, device="cpu")
    assert np.array_equal(reference_run(ref, b),
                          port.transmit_arrays(*columns(b)))


def test_state_rejects_mismatched_fabric():
    ref = rfb.ReferenceFabric(REF_CFG, 2, n_ranks=4)
    port = pfb.Fabric(pfb.DEFAULT_NET, 3, n_ranks=4)
    with pytest.raises(ValueError, match="ranks, VCIs"):
        state.load_fabric_state(port, state.fabric_state(ref))


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        pft.TorchFabric(pfb.DEFAULT_NET, 2, n_ranks=4)
    with pytest.raises(RuntimeError, match="cuda"):
        pfc.CudaFabric(pfb.DEFAULT_NET, 2, n_ranks=4, device="cuda")


def test_pad_layout_matches_reference():
    """The torch engine's padded stage layouts equal the JAX engine's
    host helper on the same grouping."""
    jax_fabric = pytest.importorskip("repro.core.fabric_jax")
    b = random_batch(5, n_ranks=8, n=400)
    lay = pfb._group_layout(b["src"] * 8 + b["dst"])
    got = pft._pad_layout(lay, 400, 512, G=64, K=32)
    want = jax_fabric._pad_layout(lay, 400, 512, G=64, K=32)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert pft._consts(pfb.DEFAULT_NET) == jax_fabric._consts(rfb.DEFAULT_NET)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["finish", "arrivals"])
def test_cuda_kernel_matches_plain_version(mode, cuda_device):
    """The hand-written kernel on the card, bitwise against its plain
    version, in one launch per super-batch: random traffic (ragged rank
    depths) and a stencil point."""
    pfc.clear_memos()
    b = random_batch(8, n_ranks=64, n=20000)
    link = b["src"] * 64 + b["dst"]
    links, fid = np.unique(link, return_inverse=True)
    item = state.grid_item_from_arrays(**b, cfg=pfb.DEFAULT_NET, n_vcis=4,
                                       n_ranks=64)
    fin = pfc.FinishSpec(
        fid=fid, foff=np.random.default_rng(8).uniform(0, 1e-6, len(links)),
        fdst=links % 64, n_ranks=64)
    (prep, order, stencil, _), = psim._grid_entries([dict(
        approach="part", dims=(4, 4, 2), theta=4, n_threads=2, n_vcis=2,
        local_shape=(64, 64, 64))])
    for items, fins in (([item], [fin]),
                        ([stencil], [psim._cuda_finish_spec(prep, order)])):
        ops, _ = pfc.grid_ops(items, fins if mode == "finish" else None,
                              cuda_device)
        before = pfc.LAUNCHES["fabric_scan"]
        got = pfc.fabric_scan(ops)
        assert pfc.LAUNCHES["fabric_scan"] == before + 1
        want = pfc.fabric_scan_ref(ops)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    pfc.clear_memos()