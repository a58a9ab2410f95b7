"""The fused fabric kernel's plain version against the Pallas kernel.

``fabric_scan_ref`` (the CUDA kernel's plain PyTorch version, which the
port's ``cuda`` engine runs for CPU tensors) is held bit for bit against
the JAX package's ``core/fabric_pallas.py`` kernel, run as that
package's own tests run it on the CPU: x64 on, Pallas in interpret mode,
and against the scalar ``ReferenceFabric``.  Both get the same grid
items, built from numpy seeds.  Cases cover the finish and arrivals
modes, the source-rank-major layout (stencil points, whose warps share
one depth, and random traffic with ragged depths, a Zipf-heavy rank and
ranks that send or receive nothing), the finish as an order-free max,
and the warm ``transmit_arrays`` path with its carried-out clocks.  The
CUDA kernel itself is tested on the card in ``test_torch_fabric.py``.
"""

import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from _engines import forced_scans as forced_reference_scans  # noqa: E402
from repro import compat  # noqa: E402
from repro.core import fabric as rfb  # noqa: E402
from repro.core import fabric_jax as rfj  # noqa: E402
from repro.core import fabric_pallas as rfp  # noqa: E402
from repro.core import simulator as rsim  # noqa: E402
from repro.kernels import runtime as rrt  # noqa: E402
from repro_torch.core import fabric as pfb  # noqa: E402
from repro_torch.core import fabric_cuda as pfc  # noqa: E402
from repro_torch.core import simulator as psim  # noqa: E402
from repro_torch.core import state  # noqa: E402

STENCIL_POINTS = [dict(approach=ap, dims=d, theta=4, n_threads=2, n_vcis=2,
                       local_shape=(64, 64, 64), bytes_per_cell=8.0)
                  for ap in ("pt2pt_single", "part", "pt2pt_many")
                  for d in ((2, 2, 2), (3, 2, 2))]


@contextlib.contextmanager
def reference_kernel():
    """The reference kernel as its own CPU tests run it."""
    with compat.x64_mode(True), rrt.force_interpret(True):
        yield


@pytest.fixture
def forced(monkeypatch):
    """Every port batch through the staged scans / kernels, however
    narrow (the port's own adaptive cutoffs set to 0)."""
    monkeypatch.setattr(pfb, "SCALAR_BATCH_CUTOFF", 0)
    monkeypatch.setattr(pfb, "MIN_GROUP_PARALLELISM", 0)


def random_traffic(seed, n_ranks=48, n_flows=220, max_len=30, silent=0):
    """Numpy columns of a random super-batch: flows of 1..max_len
    messages between Zipf-skewed sender ranks, so the rank-records'
    depths are ragged and rank 0's is far the deepest; the last
    ``silent`` ranks receive nothing."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len, size=n_flows)
    fsrc = np.minimum(rng.zipf(1.4, size=n_flows) - 1, n_ranks - 1)
    fdst = rng.integers(0, n_ranks - silent, size=n_flows)
    fid = rng.permutation(np.repeat(np.arange(n_flows), lens))
    n = fid.shape[0]
    cols = dict(t_ready=np.sort(rng.uniform(0.0, 40e-6, size=n)),
                nbytes=rng.choice([64.0, 2048.0, 16384.0, 131072.0],
                                  size=n),
                vci=rng.integers(0, 3, size=n),
                thread=rng.integers(0, 3, size=n),
                put=rng.random(n) < 0.2, am_copy=rng.random(n) < 0.05,
                src=fsrc[fid], dst=fdst[fid])
    fin = dict(fid=fid, foff=rng.uniform(0.0, 1e-6, size=n_flows),
               fdst=fdst, n_ranks=n_ranks)
    return cols, fin, n_ranks


def both_items(cols, n_ranks, n_vcis=3, key=None):
    """The same columns as a reference and a port grid item."""
    ref = rfj.GridItem(**cols, cfg=rfb.DEFAULT_NET, n_vcis=n_vcis,
                       n_ranks=n_ranks, key=key)
    port = state.grid_item_from_arrays(**cols, cfg=pfb.DEFAULT_NET,
                                       n_vcis=n_vcis, n_ranks=n_ranks,
                                       key=key)
    return ref, port


def stencil_items(points):
    """Reference and port grid items + finish specs of stencil points,
    assembled by each package's own simulator."""
    ref_items, ref_fins, port_items, port_fins = [], [], [], []
    for p in points:
        prep = rsim._prepare_stencil(**p)
        order = rsim._merge_order(prep.cols["t_ready"], prep.memo_key)
        c = prep.cols
        ref_items.append(rfj.GridItem(
            **{k: c[k][order] for k in ("t_ready", "nbytes", "vci", "thread",
                                        "put", "am_copy", "src", "dst")},
            cfg=prep.cfg, n_vcis=prep.n_vcis, n_ranks=prep.n_ranks,
            key=prep.memo_key))
        ref_fins.append(rsim._pallas_finish_spec(prep, order))
    for prep, order, item, _ in psim._grid_entries(points):
        port_items.append(item)
        port_fins.append(psim._cuda_finish_spec(prep, order))
    return ref_items, ref_fins, port_items, port_fins


def reference_arrivals(cols, n_ranks, n_vcis=3):
    """Per-message arrivals of the scalar oracle, message by message."""
    fab = pfb.ReferenceFabric(pfb.DEFAULT_NET, n_vcis, n_ranks=n_ranks)
    return np.array([fab.transmit(
        float(cols["t_ready"][i]), float(cols["nbytes"][i]),
        int(cols["vci"][i]), int(cols["thread"][i]),
        put=bool(cols["put"][i]), am_copy=bool(cols["am_copy"][i]),
        src=int(cols["src"][i]), dst=int(cols["dst"][i]))
        for i in range(cols["t_ready"].shape[0])])


def flow_then_rank_max(arrivals, fin):
    """The finish as the reference reduces it: per-flow max arrival, +
    the flow's offset, per-rank max (0.0 where nothing arrives)."""
    F = len(fin["foff"])
    fmax = np.full(F, -np.inf)
    np.maximum.at(fmax, fin["fid"], arrivals)
    out = np.zeros(fin["n_ranks"])
    np.maximum.at(out, fin["fdst"], fmax + fin["foff"])
    return out


def test_stencil_grid_finish_mode():
    ref_items, ref_fins, items, fins = stencil_items(STENCIL_POINTS)
    with reference_kernel():
        want = rfp.transmit_grid_finish(ref_items, ref_fins)
    got = pfc.transmit_grid_finish(items, fins, device="cpu")
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_stencil_grid_arrivals_mode():
    ref_items, _, items, _ = stencil_items(STENCIL_POINTS)
    with reference_kernel():
        want = rfp.transmit_grid(ref_items)
    got = pfc.transmit_grid(items, device="cpu")
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w))


def test_stencil_layout_coalesces():
    """A stencil super-batch: every message at one layout position, the
    records deepest first, and only a warp that straddles two depths has
    records with a tail beyond the interleaved part (so nearly every
    load is interleaved across its warp); every block's carries in
    shared memory."""
    _, _, items, fins = stencil_items(STENCIL_POINTS)
    ops, _ = pfc.grid_ops(items, fins, "cpu")
    desc = ops.desc.numpy()
    depth = desc[:, pfc.DEPTH]
    assert np.all(np.diff(depth) <= 0)
    cta = ops.cta.numpy()
    blk = np.repeat(np.arange(len(cta) - 1), np.diff(cta))
    warp = blk * pfc.THREADS + (np.arange(len(desc)) - cta[blk]) // pfc.WARP
    ragged = np.unique(warp[desc[:, pfc.KW] < depth])
    assert len(ragged) <= len(np.unique(depth)) - 1
    assert np.all(desc[:, pfc.SOFF] >= 0)
    _, _, pos = pfc._positions(desc)
    assert np.array_equal(np.sort(pos), np.arange(ops.n))
    assert len(desc) == sum(len(np.unique(it.src)) for it in items)
    assert np.all(np.diff(cta) <= pfc.THREADS)
    assert np.all(ops.foff.numpy() >= 0)


@pytest.mark.parametrize("lone", [0, 32, 1 << 30])
@pytest.mark.parametrize("mode", ["finish", "arrivals"])
def test_ragged_traffic_matches_reference(mode, lone, monkeypatch):
    """Random traffic with ragged rank depths, one Zipf-heavy rank,
    ranks that send nothing and ranks that receive nothing: equal to
    the Pallas kernel and to the scalar oracle, whether the plain
    version walks the records as tensor steps (``lone`` 0), on host
    floats (``lone`` past the record count), or switches midway."""
    monkeypatch.setattr(pfc, "LONE_RECORDS", lone)
    cols, fin, n_ranks = random_traffic(0, n_ranks=96, n_flows=600,
                                        silent=4)
    ref_item, item = both_items(cols, n_ranks)
    per_rank = np.bincount(cols["src"], minlength=n_ranks)
    assert per_rank.max() > 5 * per_rank[per_rank > 0].mean()
    assert np.any(per_rank == 0)
    assert not np.isin(np.arange(n_ranks - 4, n_ranks), fin["fdst"]).any()
    ops, _ = pfc.grid_ops([item], [pfc.FinishSpec(**fin)]
                          if mode == "finish" else None, "cpu")
    depth = ops.desc.numpy()[:, pfc.DEPTH]
    assert len(np.unique(depth)) > 8 and len(depth) > 32
    oracle = reference_arrivals(cols, n_ranks)
    if mode == "finish":
        got = pfc.transmit_grid_finish([item], [pfc.FinishSpec(**fin)],
                                       device="cpu")
        assert np.array_equal(got[0], flow_then_rank_max(oracle, fin))
        assert np.all(got[0][n_ranks - 4:] == 0.0)
    else:
        got = pfc.transmit_grid([item], device="cpu")
        assert np.array_equal(got[0], oracle)
    if lone == 32:  # the Pallas kernel's result does not depend on it
        with reference_kernel():
            want = (rfp.transmit_grid_finish([ref_item],
                                             [rfp.FinishSpec(**fin)])
                    if mode == "finish" else rfp.transmit_grid([ref_item]))
        assert np.array_equal(got[0], np.asarray(want[0]))


def test_finish_max_is_order_free():
    """The kernel's finish takes atomicMax in whatever order its threads
    reach it.  Max is exact, so the per-rank result of the messages'
    ``arrival + foff`` is the same bits in any order: the plain
    reduction over a shuffled message order equals the ordered one."""
    cols, fin, n_ranks = random_traffic(3, silent=2)
    _, item = both_items(cols, n_ranks)
    arr = torch.from_numpy(pfc.transmit_grid([item], device="cpu")[0])
    vals = arr + torch.from_numpy(fin["foff"][fin["fid"]])
    dst = torch.from_numpy(fin["fdst"][fin["fid"]])
    ordered = pfc.rank_max(n_ranks, dst, vals)
    for seed in range(3):
        p = torch.from_numpy(np.random.default_rng(seed).permutation(
            vals.shape[0]))
        assert torch.equal(pfc.rank_max(n_ranks, dst[p], vals[p]), ordered)
    assert torch.equal(ordered[n_ranks - 2:], torch.zeros(2,
                                                          dtype=torch.float64))


def test_finish_equals_flow_max_then_rank_max():
    """``fl(x + c)`` is monotonic in ``x``, so the per-rank max over
    messages of arrival + foff equals the flow max, + foff, then the
    rank max, bit for bit, on random traffic."""
    cols, fin, n_ranks = random_traffic(4, silent=3)
    _, item = both_items(cols, n_ranks)
    arr = pfc.transmit_grid([item], device="cpu")[0]
    got = pfc.transmit_grid_finish([item], [pfc.FinishSpec(**fin)],
                                   device="cpu")[0]
    assert np.array_equal(got, flow_then_rank_max(arr, fin))


def test_records_that_overflow_shared_memory(monkeypatch):
    """A rank-record whose VCI and link carries exceed a block's shared
    memory is rejected before anything is uploaded, as a rank with too
    many VCIs or links is."""
    cols, fin, n_ranks = random_traffic(2)
    _, item = both_items(cols, n_ranks)
    pfc.clear_memos()
    monkeypatch.setattr(pfc, "SMEM_DOUBLES", 24)
    with pytest.raises(ValueError, match="more than 24 VCI and link"):
        pfc.grid_ops([item], [pfc.FinishSpec(**fin)], "cpu")
    pfc.clear_memos()


def test_blocks_shrink_to_fit_shared_memory(monkeypatch):
    """With a shared-memory share just large enough for the heaviest
    record, the blocks take fewer records, each block's carries fit its
    share, and the result is unchanged."""
    cols, fin, n_ranks = random_traffic(2)
    _, item = both_items(cols, n_ranks)
    want = pfc.transmit_grid_finish([item], [pfc.FinishSpec(**fin)], "cpu")
    pfc.clear_memos()
    ops, _ = pfc.grid_ops([item], [pfc.FinishSpec(**fin)], "cpu")
    need = (ops.desc[:, pfc.NV] + ops.desc[:, pfc.NL]).numpy()
    pfc.clear_memos()
    monkeypatch.setattr(pfc, "SMEM_DOUBLES", int(need.max()))
    ops, _ = pfc.grid_ops([item], [pfc.FinishSpec(**fin)], "cpu")
    desc = ops.desc.numpy()
    assert ops.smem <= need.max()
    assert np.all(desc[:, pfc.SOFF] + desc[:, pfc.NV] + desc[:, pfc.NL]
                  <= ops.smem)
    assert len(ops.cta) - 1 > -(-len(desc) // pfc.THREADS)
    got = pfc.transmit_grid_finish([item], [pfc.FinishSpec(**fin)], "cpu")
    pfc.clear_memos()
    assert np.array_equal(got[0], want[0])


def test_carry_outs_match_reference_kernel():
    """Arrivals mode from non-zero warm clocks: the per-message
    arrivals and the three per-group carry-out vectors equal the Pallas
    kernel's outputs on the same operands."""
    cols, _, n_ranks = random_traffic(0)  # reuses the arrivals build
    n_vcis, n = 3, cols["t_ready"].shape[0]
    lays = rfj._raw_layouts(cols["src"], cols["dst"], cols["vci"] % n_vcis,
                            n_vcis, n_ranks, None)
    rng = np.random.default_rng(11)
    warm = [rng.uniform(0.0, 10e-6, size=len(lay[1])) for lay in lays]
    warm_prev = rng.integers(-1, 3, size=len(lays[0][1]))
    c1, c3, rdv = rfp._cost_columns(
        cols["t_ready"], cols["nbytes"], cols["thread"], cols["put"],
        cols["am_copy"], rfb.DEFAULT_NET, lays[0], warm_prev)
    with reference_kernel():
        core, statics, orders = rfp._arr_structure(lays, n)
        dyn = [jax.numpy.asarray(a) for a in
               (cols["t_ready"], c1, c3, rdv,
                *(w[o] for w, o in zip(warm, orders)))]
        consts = jax.numpy.asarray(np.array(rfj._consts(rfb.DEFAULT_NET)))
        want = rfp._build_call(rfp._runtime_meta(core, "arrivals"))(
            consts, *dyn, *statics)
        want = [np.asarray(w) for w in want]
    ops, perm, slot = pfc._arr_structure(lays, n_vcis, n_ranks,
                                         torch.device("cpu"))
    pc1, pc3, prdv = pfc._cost_columns(
        cols["t_ready"], cols["nbytes"], cols["thread"], cols["put"],
        cols["am_copy"], pfb.DEFAULT_NET, lays[0], warm_prev)
    for a, b in zip((c1, c3, rdv), (pc1, pc3, prdv)):
        assert np.array_equal(a, b)
    t = torch.from_numpy
    ops = pfc._set_costs(pfc.dataclasses.replace(
        ops, t_ready=t(cols["t_ready"][perm]), c1=t(pc1[perm]),
        c3=t(pc3[perm]), slot=t(pfc._slot_words(slot, prdv[perm])),
        init=tuple(t(w) for w in warm)), pfb.DEFAULT_NET)
    got = [x.numpy() for x in pfc.fabric_scan_ref(ops)]
    assert len(np.unique(ops.desc.numpy()[:, pfc.DEPTH])) > 8
    assert np.array_equal(got[0], want[0])
    # the port's carries are in stage group order, the reference's in
    # its buckets' group order
    for g, w, o in zip(got[1:], want[1:], orders):
        assert np.array_equal(g[o], w)


def test_warm_transmit_arrays_matches_pallas_fabric(forced):
    """Two successive batches through CudaFabric (CPU) and the
    reference's PallasFabric: arrivals and warm state equal."""
    cols, _, n_ranks = random_traffic(0)
    order = ("t_ready", "nbytes", "vci", "thread", "put", "am_copy", "src",
             "dst")
    ref = rfp.PallasFabric(rfb.DEFAULT_NET, 3, n_ranks=n_ranks)
    port = pfc.CudaFabric(pfb.DEFAULT_NET, 3, n_ranks=n_ranks, device="cpu")
    with reference_kernel(), forced_reference_scans():
        for shift in (0.0, 30e-6):  # the second batch finds warm state
            batch = [cols[k] + shift if k == "t_ready" else cols[k]
                     for k in order]
            assert np.array_equal(ref.transmit_arrays(*batch),
                                  port.transmit_arrays(*batch))
    a, b = state.fabric_state(ref), state.fabric_state(port)
    for k in a:
        assert (np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray)
                else a[k] == b[k]), k


def test_wrapper_on_cpu_runs_plain_version():
    """CPU operands take the plain version and count no launch."""
    cols, fin, n_ranks = random_traffic(5, n_flows=40)
    _, item = both_items(cols, n_ranks)
    ops, _ = pfc.grid_ops([item], [pfc.FinishSpec(**fin)], "cpu")
    before = pfc.LAUNCHES["fabric_scan"]
    assert torch.equal(pfc.fabric_scan(ops), pfc.fabric_scan_ref(ops))
    assert pfc.LAUNCHES["fabric_scan"] == before


def test_operand_checks_reject_bad_operands():
    cols, fin, n_ranks = random_traffic(6, n_flows=40)
    _, item = both_items(cols, n_ranks)
    ops, _ = pfc.grid_ops([item], [pfc.FinishSpec(**fin)], "cpu")
    pfc._check_operands(ops, torch.device("cpu"))
    bad = pfc.dataclasses.replace(ops, c1=ops.c1.float())
    with pytest.raises(ValueError, match="c1"):
        pfc._check_operands(bad, torch.device("cpu"))
    bad = pfc.dataclasses.replace(ops, slot=ops.slot.long())
    with pytest.raises(ValueError, match="slot"):
        pfc._check_operands(bad, torch.device("cpu"))
    bad = pfc.dataclasses.replace(ops, desc=ops.desc[:, :-1].contiguous())
    with pytest.raises(ValueError, match="desc"):
        pfc._check_operands(bad, torch.device("cpu"))


def test_index_bounds_checked_before_upload():
    """A VCI or link slot beyond its record's carries, a record position
    off the layout and an output index past the ranks are all refused
    before anything is uploaded."""
    cols, fin, n_ranks = random_traffic(7, n_flows=40)
    _, item = both_items(cols, n_ranks)
    ops, _ = pfc._assemble([item], [pfc.FinishSpec(**fin)])
    pfc._upload(ops, torch.device("cpu"))
    desc = ops.desc
    r = int(np.argmax(desc[:, pfc.NL]))  # a record with several links
    _, _, pos = pfc._positions(desc[r:r + 1])
    p = int(pos[0])
    word = ops.slot.view(np.uint32)
    for bad_word in (word[p] | np.uint32(pfc.VCI_LIMIT - 1),
                     word[p] | np.uint32(desc[r, pfc.NL] << 8)):
        slot = word.copy()
        slot[p] = bad_word
        with pytest.raises(ValueError, match="slot index"):
            pfc._upload(pfc.dataclasses.replace(
                ops, slot=slot.view(np.int32)), torch.device("cpu"))
    bad = desc.copy()
    bad[r, pfc.TAIL] = ops.n
    with pytest.raises(ValueError, match="position"):
        pfc._upload(pfc.dataclasses.replace(ops, desc=bad),
                    torch.device("cpu"))
    out = ops.out.copy()
    out[0] = n_ranks
    with pytest.raises(ValueError, match="output index"):
        pfc._upload(pfc.dataclasses.replace(ops, out=out),
                    torch.device("cpu"))


def test_operands_match_kernel_source():
    """The host's descriptor width, block size and slot encoding are
    the kernel's (``csrc/fabric_scan.cu``), which no CPU test runs."""
    import re
    src = (Path(pfc.__file__).resolve().parents[1] / "csrc"
           / "fabric_scan.cu").read_text()
    body = re.search(r"struct __align__\(16\) Record \{(.*?)\};", src,
                     re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = re.findall(r"\b\w+\b(?=\s*[,;])", body.replace("int ", ""))
    assert len(fields) == pfc.DESC_FIELDS == 12
    assert [fields.index(f) for f in ("m0", "stride", "kw", "tail", "depth",
                                      "rec", "cv0", "nv", "cl0", "nl",
                                      "soff")] == list(range(11))
    assert f"kThreads = {pfc.THREADS};" in src
    assert "kVciMask = 0xffu" in src and pfc.VCI_LIMIT == 0x100
    assert "kLinkMask = 0x7fffffu" in src and pfc.LINK_LIMIT == 0x800000
    assert "kRdvBit = 1u << 31" in src and pfc.RDV_BIT == 1 << 31
