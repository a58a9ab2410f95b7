"""The float32 build of the fused fabric kernel on the card.

``csrc/fabric_scan.cu``'s ``fabric_rank_scan_f32`` against its plain
version ``fabric_scan_ref`` on the same float32 operands, bitwise, in
finish and arrivals mode, on random traffic whose rank-records are
ragged (Zipf-skewed senders, some ranks receiving nothing) and on a
stencil point, one launch a super-batch counted under
``fabric_scan_f32`` and not under ``fabric_scan_f64``.  Every test here
needs the card (``-m gpu``); the file imports no JAX, so it runs there.
On the CPU the float32 plain version is held against the JAX package's
engines in ``tests/test_torch_fabric_f32.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch import compat
from repro_torch.core import fabric as pfb
from repro_torch.core import fabric_cuda as pfc
from repro_torch.core import simulator as psim
from repro_torch.core import state


def random_item(seed, n_ranks=64, n_flows=400, max_len=40, silent=3):
    """A random super-batch of ragged rank-records and its finish."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len, size=n_flows)
    fsrc = np.minimum(rng.zipf(1.4, size=n_flows) - 1, n_ranks - 1)
    fdst = rng.integers(0, n_ranks - silent, size=n_flows)
    fid = rng.permutation(np.repeat(np.arange(n_flows), lens))
    n = fid.shape[0]
    item = state.grid_item_from_arrays(
        t_ready=np.sort(rng.uniform(0.0, 40e-6, size=n)),
        nbytes=rng.choice([64.0, 2048.0, 16384.0, 131072.0], size=n),
        vci=rng.integers(0, 3, size=n), thread=rng.integers(0, 3, size=n),
        put=rng.random(n) < 0.2, am_copy=rng.random(n) < 0.05,
        src=fsrc[fid], dst=fdst[fid], cfg=pfb.DEFAULT_NET, n_vcis=3,
        n_ranks=n_ranks)
    fin = pfc.FinishSpec(fid=fid, foff=rng.uniform(0.0, 1e-6, size=n_flows),
                         fdst=fdst, n_ranks=n_ranks)
    return item, fin


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["finish", "arrivals"])
def test_f32_kernel_matches_plain_version(mode, cuda_device):
    pfc.clear_memos()
    item, fin = random_item(8)
    (prep, order, stencil, _), = psim._grid_entries([dict(
        approach="part", dims=(4, 4, 2), theta=4, n_threads=2, n_vcis=2,
        local_shape=(64, 64, 64))])
    for items, fins in (([item], [fin]),
                        ([stencil], [psim._cuda_finish_spec(prep, order)])):
        with compat.x64_mode(False):
            ops, _ = pfc.grid_ops(items, fins if mode == "finish" else None,
                                  cuda_device)
        assert ops.t_ready.dtype == torch.float32
        before = dict(pfc.LAUNCHES)
        got = pfc.fabric_scan(ops)
        assert pfc.LAUNCHES["fabric_scan_f32"] == \
            before["fabric_scan_f32"] + 1
        assert pfc.LAUNCHES["fabric_scan_f64"] == before["fabric_scan_f64"]
        want = pfc.fabric_scan_ref(ops)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and torch.equal(g, w)
    pfc.clear_memos()


@pytest.mark.gpu
def test_f32_warm_path_matches_plain_version(cuda_device, monkeypatch):
    """The warm driver path (carried clocks in and out) in float32,
    every batch through the kernel (cutoffs at 0): the card's fabric
    equals the CPU's plain version batch after batch."""
    monkeypatch.setattr(pfb, "SCALAR_BATCH_CUTOFF", 0)
    monkeypatch.setattr(pfb, "MIN_GROUP_PARALLELISM", 0)
    item, _ = random_item(9)
    cols = (item.t_ready, item.nbytes, item.vci, item.thread, item.put,
            item.am_copy, item.src, item.dst)
    card = pfc.CudaFabric(item.cfg, item.n_vcis, n_ranks=item.n_ranks,
                          device=cuda_device)
    host = pfc.CudaFabric(item.cfg, item.n_vcis, n_ranks=item.n_ranks,
                          device="cpu")
    before = pfc.LAUNCHES["fabric_scan_f32"]
    with compat.x64_mode(False):
        for _ in range(2):
            assert np.array_equal(card.transmit_arrays(*cols),
                                  host.transmit_arrays(*cols))
    assert pfc.LAUNCHES["fabric_scan_f32"] == before + 2
    assert card.nic_free == host.nic_free
    assert card.wire_free == host.wire_free
