"""The fused fabric kernel's plain version against the Pallas kernel.

``fabric_scan_ref`` (the CUDA kernel's plain PyTorch version, which the
port's ``cuda`` engine runs for CPU tensors) is held bit for bit against
the JAX package's ``core/fabric_pallas.py`` kernel, run as that
package's own tests run it on the CPU: x64 on, Pallas in interpret mode.
Both get the same grid items, built from numpy seeds.  Cases cover the
finish and arrivals modes, exact-depth stage buckets (stencil points)
and masked ones (random traffic with many distinct chain depths), and
the warm ``transmit_arrays`` path with its carried-out clocks.  The
CUDA kernel itself is tested on the card in ``test_torch_fabric.py``.
"""

import contextlib

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


def random_traffic(seed, n_ranks=48, n_flows=220, max_len=30):
    """Numpy columns of a random super-batch: flows of 1..max_len
    messages between skewed sender ranks, so each stage's groups and
    the finish groups span far more than ``MAX_EXACT_DEPTHS`` depths."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len, size=n_flows)
    fsrc = np.minimum(rng.zipf(1.4, size=n_flows) - 1, n_ranks - 1)
    fdst = rng.integers(0, n_ranks, size=n_flows)
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


def masked_bucket_count(ops):
    return sum(b.mask is not None for bks in ops.stages for b in bks) + sum(
        b.mask is not None for b in (*ops.fin_flows, *ops.fin_ranks))


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


def test_stencil_buckets_are_exact_depth():
    _, _, items, fins = stencil_items(STENCIL_POINTS)
    ops, _ = pfc.grid_ops(items, fins, "cpu")
    assert masked_bucket_count(ops) == 0


@pytest.mark.parametrize("mode", ["finish", "arrivals"])
def test_masked_buckets_match_reference(mode):
    cols, fin, n_ranks = random_traffic(0)
    ref_item, item = both_items(cols, n_ranks)
    fins = [pfc.FinishSpec(**fin)] if mode == "finish" else None
    ops, _ = pfc.grid_ops([item], fins, "cpu")
    assert masked_bucket_count(ops) >= 3  # every stage goes masked
    with reference_kernel():
        if mode == "finish":
            want = rfp.transmit_grid_finish([ref_item],
                                            [rfp.FinishSpec(**fin)])
            got = pfc.transmit_grid_finish([item], fins, device="cpu")
        else:
            want = rfp.transmit_grid([ref_item])
            got = pfc.transmit_grid([item], device="cpu")
    assert np.array_equal(got[0], np.asarray(want[0]))


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
    ops, p_orders = pfc._arr_structure(lays, n, torch.device("cpu"))
    pc1, pc3, prdv = pfc._cost_columns(
        cols["t_ready"], cols["nbytes"], cols["thread"], cols["put"],
        cols["am_copy"], pfb.DEFAULT_NET, lays[0], warm_prev)
    for a, b in zip((c1, c3, rdv), (pc1, pc3, prdv)):
        assert np.array_equal(a, b)
    t = torch.from_numpy
    ops = pfc._set_costs(pfc.dataclasses.replace(
        ops, t_ready=t(cols["t_ready"]), c1=t(pc1), c3=t(pc3), rdv=t(prdv),
        init=tuple(t(w[o]) for w, o in zip(warm, p_orders))),
        pfb.DEFAULT_NET)
    got = [x.numpy() for x in pfc.fabric_scan_ref(ops)]
    assert masked_bucket_count(ops) >= 3
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


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
    b0 = ops.stages[0][0]
    bad_idx = pfc.dataclasses.replace(b0, ridx=b0.ridx.long())
    bad = pfc.dataclasses.replace(
        ops, stages=([bad_idx, *ops.stages[0][1:]], *ops.stages[1:]))
    with pytest.raises(ValueError, match="release index"):
        pfc._check_operands(bad, torch.device("cpu"))


def test_index_bounds_checked_before_upload():
    cols, _, n_ranks = random_traffic(7, n_flows=40)
    _, item = both_items(cols, n_ranks)
    ops, _ = pfc._assemble([item], None)
    b0 = ops.stages[1][0]
    broken = pfc.dataclasses.replace(b0, ridx=b0.ridx + ops.sizes[0])
    ops = pfc.dataclasses.replace(
        ops, stages=(ops.stages[0], [broken, *ops.stages[1][1:]],
                     ops.stages[2]))
    with pytest.raises(ValueError, match="stage-2 release"):
        pfc._upload(ops, torch.device("cpu"))
