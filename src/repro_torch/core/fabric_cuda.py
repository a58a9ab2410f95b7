"""The CUDA fabric engine: the fused fabric kernel, written by hand for
Hopper, behind the same host-side super-batch assembly as the TPU engine.

Fourth engine of the port's fabric family (``engine="cuda"``), the
counterpart of the JAX package's ``core/fabric_pallas.py``.  It advances
the three-stage resource model — per-rank VCI banks, per-rank NIC,
per-directed-link wires — and the finish reductions with the kernels of
``csrc/fabric_scan.cu``:

  * the whole grid of sweep points is flattened into one cfg-bucketed
    super-batch; per-stage jagged groups are re-bucketed by segment
    depth — **exact-depth, mask-free buckets** when a stage has at most
    :data:`MAX_EXACT_DEPTHS` distinct depths (the common stencil case),
    padded power-of-two classes with masks otherwise;
  * per-message stage-1 costs (previous-owner injection chain, protocol
    copy costs) are precomputed on the host in float64 with exactly the
    scalar engine's operation order, so the device work is nothing but
    the queue recurrences ``t[i] = max(r[i], t[i-1]) + c[i]``, maxima
    and one gather-add;
  * the finish reduction (per-flow max arrival + affine finish offsets +
    per-rank max) runs on the device — a 32k-rank point returns 32768
    floats instead of 1.6M arrivals.

The kernel's wrapper is :func:`fabric_scan`; its plain PyTorch version,
the same bucket walk as torch tensor steps, is :func:`fabric_scan_ref`.
The wrapper takes the plain version only for operands on the CPU; for
CUDA operands it launches the kernels or raises.

Precision contract: float64, bit-for-bit equal to ``ReferenceFabric``
(host costs in float64 with the reference operation order; adding
``0.0`` is bitwise identity; ``max`` reductions are order-independent).
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import fabric as _fb
from .fabric import NetConfig
from .fabric_torch import (DTYPE, GridItem, TorchFabric, _raw_layouts,
                           resolve_device)

# A stage whose groups span at most this many distinct depths is
# bucketed by *exact* depth — no padding, no masks, no wasted lanes.
MAX_EXACT_DEPTHS = 8


@dataclass
class FinishSpec:
    """Device-side finish reduction of one grid item.

    Valid only for *affine* finishes (``finish_batch(flows, None, x) ==
    x + foff`` elementwise — the caller probes this): the kernels then
    compute per-flow max arrival + ``foff`` and the per-rank max of
    those, returning per-rank completion times directly.
    """
    fid: np.ndarray    # (n,) flow id of each merge-ordered message
    foff: np.ndarray   # (F,) affine finish offset per flow
    fdst: np.ndarray   # (F,) destination rank per flow
    n_ranks: int


@dataclass
class _Bucket:
    """One depth-class of a stage: ``idx[k, g]`` is the global message
    id of the k-th member of the bucket's g-th segment; ``mask`` marks
    real slots (None when the bucket is exact-depth); ``sel`` names the
    segments as indices into the stage's concatenated group list."""
    idx: np.ndarray
    mask: Optional[np.ndarray]
    sel: np.ndarray


def _stage_buckets(order: np.ndarray, counts: np.ndarray,
                   offsets: np.ndarray, n: int
                   ) -> Tuple[List[_Bucket], np.ndarray, int]:
    """Re-bucket one stage's jagged segments by depth class.

    Returns ``(buckets, pos, size)``: ``pos[i]`` is message i's slot in
    the stage's flat scan-output vector (concatenation of the buckets'
    raveled ``(K, G)`` matrices, ``size`` total slots).
    """
    exact = len(np.unique(counts)) <= MAX_EXACT_DEPTHS
    if exact:
        kcls = counts
    else:  # counts >= 1 always; log2 of an exact power of two is exact
        kcls = (1 << np.ceil(np.log2(np.maximum(counts, 1)))
                .astype(np.int64))
    pos = np.empty(n, dtype=np.int64)
    buckets: List[_Bucket] = []
    base = 0
    for K in np.unique(kcls).tolist():
        sel = np.nonzero(kcls == K)[0]
        G = len(sel)
        cnt = counts[sel]
        offs = offsets[sel]
        total = int(cnt.sum())
        starts = np.zeros(G, dtype=np.int64)
        np.cumsum(cnt[:-1], out=starts[1:])
        within = np.arange(total, dtype=np.int64) - np.repeat(starts, cnt)
        col = np.repeat(np.arange(G, dtype=np.int64), cnt)
        members = order[np.repeat(offs, cnt) + within]
        idx = np.zeros((K, G), dtype=np.int32)
        idx[within, col] = members
        if int(cnt.min()) == K:
            mask = None
        else:
            mask = np.zeros((K, G), dtype=bool)
            mask[within, col] = True
        pos[members] = base + within * G + col
        buckets.append(_Bucket(idx=idx, mask=mask, sel=sel))
        base += K * G
    return buckets, pos, base


def _cost_columns(t_ready, nbytes, thread, put, am_copy, cfg: NetConfig,
                  lay1, warm_prev: Optional[np.ndarray]
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-message stage costs, precomputed host-side in float64.

    Performs exactly the scalar engine's IEEE-754 operations: the
    stage-1 injection cost needs each message's predecessor on its VCI
    bank — a pure function of the (memoized) bank grouping — so it
    vectorizes as a shifted gather instead of a scan.  ``warm_prev``
    seeds each bank's chain with its stored last owner (None = cold,
    every bank starts idle).  Returns ``(c1, c3, rdv)``: stage-1 cost
    (injection + protocol copy), stage-3 wire service time, and the
    rendezvous round-trip added to stage-3 release times.
    """
    n = t_ready.shape[0]
    nb = np.asarray(nbytes, dtype=np.float64)
    copy = am_copy | ((nb > cfg.eager_max) & (nb <= cfg.bcopy_max))
    copy_cost = np.where(copy, nb / cfg.beta_copy, 0.0)
    order1, _, _, offs1 = lay1
    th_s = np.asarray(thread)[order1]
    prev_s = np.empty_like(th_s)
    prev_s[offs1] = -1 if warm_prev is None else warm_prev
    inner = np.ones(n, dtype=bool)
    inner[offs1] = False
    prev_s[inner] = th_s[np.nonzero(inner)[0] - 1]
    put_s = np.asarray(put)[order1]
    base_s = np.where(
        prev_s < 0,
        np.where(put_s, cfg.alpha_put_first, cfg.alpha_first),
        np.where(prev_s != th_s, cfg.chi_switch,
                 np.where(put_s, cfg.alpha_put, cfg.alpha_msg)))
    c1 = np.empty(n)
    c1[order1] = base_s
    c1 = c1 + copy_cost  # += 0.0 on non-copy rows: bitwise identity
    rdv = np.where(~np.asarray(am_copy) & (nb > cfg.bcopy_max),
                   2.0 * cfg.alpha_wire, 0.0)
    c3 = nb / cfg.beta
    return c1, c3, rdv


# ---------------------------------------------------------------------------
# The kernel's operands
# ---------------------------------------------------------------------------

@dataclass
class ScanBucket:
    """One depth-class of one stage, as the scan kernel takes it: the
    bucket's ``(K, G)`` lanes, step-major and flattened (lane
    ``k * G + g`` is the k-th message of segment g).  ``ridx[lane]``
    names where the lane's release time is gathered from (stage 1: the
    message's ``t_ready``; stages 2 and 3: the previous stage's scan
    output), ``cidx[lane]`` the message whose per-message costs it pays
    (stages 1 and 3; None for the NIC's constant service).  ``fo`` and
    ``go`` place the bucket in its stage's flat scan vector and group
    vector."""
    K: int
    G: int
    fo: int
    go: int
    ridx: object                # (K*G,) int32
    cidx: object                # (K*G,) int32 or None
    mask: object                # (K*G,) bool, None when exact-depth


@dataclass
class ReduceBucket:
    """One depth-class of a finish reduction: output ``go + g`` is the
    max over k of ``src[idx[k * G + g]]``, masked lanes 0-filled."""
    K: int
    G: int
    go: int
    idx: object                 # (K*G,) int32
    mask: object                # (K*G,) bool or None


@dataclass
class ScanOps:
    """Everything one super-batch hands the kernels.  Index structure
    and per-call values are held as NumPy arrays while assembled and
    as tensors on the target device once uploaded (:func:`_upload`)."""
    t_ready: object             # (n,) float64
    c1: object                  # (n,) float64 stage-1 costs
    c3: object                  # (n,) float64 wire service times
    rdv: object                 # (n,) float64 rendezvous round trips
    init: tuple                 # per stage (G_s,) float64 busy-until
    alpha_wire: float
    alpha_nic: float
    alpha_recv: float
    stages: tuple               # per stage, a list of ScanBucket
    sizes: tuple                # per stage, flat scan-vector slots
    pos3: object = None         # arrivals mode: (n,) int32 into ys3
    fin_flows: tuple = ()       # finish mode: ReduceBuckets over ys3
    fperm: object = None        # (F,) int32: flow -> flow-max slot
    foff: object = None         # (F,) float64 affine finish offsets
    fin_ranks: tuple = ()       # ReduceBuckets over per-flow finishes
    n_rank_out: int = 0

    @property
    def finish(self) -> bool:
        return self.fperm is not None

    @property
    def n(self) -> int:
        return self.t_ready.shape[0]


def _set_costs(ops: ScanOps, cfg: NetConfig) -> ScanOps:
    return dataclasses.replace(ops, alpha_wire=float(cfg.alpha_wire),
                               alpha_nic=float(cfg.alpha_nic),
                               alpha_recv=float(cfg.alpha_recv))


def _pack_stage_ops(b1, b2, b3, pos1, pos2):
    """The three stages' scan buckets in launch order, plus each
    stage's bucket-major group permutation (for warm-state init and
    readback vectors).  Stage 2 gathers stage-1 outputs by ``pos1``,
    stage 3 stage-2 outputs by ``pos2``; the permutations are resolved
    here on the host, once per structure."""
    stages = []
    grp_orders = []
    for s, bks in enumerate((b1, b2, b3)):
        out = []
        fo = go = 0
        for bk in bks:
            K, G = bk.idx.shape
            idx = bk.idx.ravel()
            if s == 0:
                ridx, cidx = idx, idx
            elif s == 1:
                ridx, cidx = pos1[idx].astype(np.int32), None
            else:
                ridx, cidx = pos2[idx].astype(np.int32), idx
            out.append(ScanBucket(
                K=K, G=G, fo=fo, go=go, ridx=ridx, cidx=cidx,
                mask=None if bk.mask is None else bk.mask.ravel()))
            fo += K * G
            go += G
        stages.append(out)
        grp_orders.append(np.concatenate([bk.sel for bk in bks]))
    return tuple(stages), grp_orders


def _reduce_buckets(buckets: List[_Bucket], values) -> List[ReduceBucket]:
    """Finish-reduction buckets; ``values`` maps each bucket's member
    ids to the positions the reduction reads."""
    out = []
    go = 0
    for bk in buckets:
        K, G = bk.idx.shape
        out.append(ReduceBucket(
            K=K, G=G, go=go, idx=values(bk.idx.ravel()).astype(np.int32),
            mask=None if bk.mask is None else bk.mask.ravel()))
        go += G
    return out


def _check_indices(ops: ScanOps) -> None:
    """Bounds of every host index array, checked before upload: the
    kernels trust their indices."""
    n, (s1, s2, s3) = ops.n, ops.sizes
    if max(n, s1, s2, s3) >= 2 ** 31:
        raise ValueError("super-batch too large for int32 indices")

    def within(a, hi, what):
        if a is not None and a.size and (int(a.min()) < 0
                                         or int(a.max()) >= hi):
            raise ValueError(f"{what} index outside [0, {hi})")
    for s, (src_len, bks) in enumerate(zip((n, s1, s2), ops.stages)):
        for b in bks:
            within(b.ridx, src_len, f"stage-{s + 1} release")
            within(b.cidx, n, f"stage-{s + 1} cost")
    within(ops.pos3, s3, "arrival")
    if ops.finish:
        F = ops.fperm.shape[0]
        for b in ops.fin_flows:
            within(b.idx, s3, "flow-max")
        within(ops.fperm, F, "flow permutation")
        for b in ops.fin_ranks:
            within(b.idx, F, "rank-max")


def _upload(ops: ScanOps, device) -> ScanOps:
    """Copy an assembled super-batch's arrays to ``device``."""
    _check_indices(ops)

    def t(a):
        if a is None:
            return None
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def bucket(b):
        ridx = t(b.ridx)  # stage 1 gathers and pays by the same index
        cidx = ridx if b.cidx is b.ridx else t(b.cidx)
        return dataclasses.replace(b, ridx=ridx, cidx=cidx, mask=t(b.mask))

    def rbucket(b):
        return dataclasses.replace(b, idx=t(b.idx), mask=t(b.mask))
    return dataclasses.replace(
        ops, t_ready=t(ops.t_ready), c1=t(ops.c1), c3=t(ops.c3),
        rdv=t(ops.rdv), init=tuple(t(a) for a in ops.init),
        stages=tuple([bucket(b) for b in bks] for bks in ops.stages),
        pos3=t(ops.pos3),
        fin_flows=tuple(rbucket(b) for b in ops.fin_flows),
        fperm=t(ops.fperm), foff=t(ops.foff),
        fin_ranks=tuple(rbucket(b) for b in ops.fin_ranks))


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------

def _lanes(src: torch.Tensor, idx: torch.Tensor, K: int, G: int):
    return src[idx.long()].view(K, G)


def fabric_scan_ref(ops: ScanOps):
    """The fused fabric kernel's plain PyTorch version.

    Walks the same buckets in the same order as the kernels — a Python
    loop down each bucket's depth axis, vectorized over its segments —
    with the same IEEE-754 operations.  Finish mode returns the
    ``(n_rank_out,)`` per-rank times; arrivals mode returns
    ``(arrivals (n,), carry1, carry2, carry3)``, the carries being each
    stage's per-group busy-until time without the delivery tail.
    """
    dev = ops.t_ready.device
    ys = [torch.empty(s, dtype=DTYPE, device=dev) for s in ops.sizes]
    carry = [a.clone() for a in ops.init]
    srcs = (ops.t_ready, ys[0], ys[1])
    for s, bks in enumerate(ops.stages):
        for b in bks:
            r = _lanes(srcs[s], b.ridx, b.K, b.G)
            if s == 2:  # rendezvous RTS/CTS delays the wire-queue entry
                r = r + _lanes(ops.rdv, b.cidx, b.K, b.G)
            c = (_lanes(ops.c1, b.cidx, b.K, b.G) if s == 0 else
                 None if s == 1 else _lanes(ops.c3, b.cidx, b.K, b.G))
            m = None if b.mask is None else b.mask.view(b.K, b.G)
            cur = carry[s][b.go:b.go + b.G].clone()
            out = ys[s][b.fo:b.fo + b.K * b.G].view(b.K, b.G)
            for k in range(b.K):
                t = torch.maximum(r[k], cur) + \
                    (ops.alpha_nic if c is None else c[k])
                out[k] = t
                cur = t if m is None else torch.where(m[k], t, cur)
            if s == 2:  # the carried state excludes the delivery tail
                out.add_(ops.alpha_wire).add_(ops.alpha_recv)
            carry[s][b.go:b.go + b.G] = cur
    if not ops.finish:
        return (ys[2][ops.pos3.long()], *carry)

    def colmax(src, b, out):
        v = _lanes(src, b.idx, b.K, b.G)
        if b.mask is not None:  # arrivals > 0: 0-fill is safe
            v = torch.where(b.mask.view(b.K, b.G), v, torch.zeros_like(v))
        out[b.go:b.go + b.G] = v.amax(dim=0)
    F = ops.fperm.shape[0]
    fmb = torch.empty(F, dtype=DTYPE, device=dev)
    for b in ops.fin_flows:
        colmax(ys[2], b, fmb)
    fin = fmb[ops.fperm.long()] + ops.foff
    rank_out = torch.empty(ops.n_rank_out, dtype=DTYPE, device=dev)
    for b in ops.fin_ranks:
        colmax(fin, b, rank_out)
    return rank_out


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------

# Launch count of the hand-written kernels: one per CUDA kernel launch
# the wrapper makes (a super-batch is several), and nowhere else.
LAUNCHES = {"fabric_scan": 0}

_LIB: Dict[str, ctypes.CDLL] = {}
_VP, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


def _library() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/fabric_scan.cu``."""
    lib = _LIB.get("fabric_scan")
    if lib is None:
        from ..kernels import build
        lib = build.load("fabric_scan")
        lib.fabric_bucket_scan.argtypes = [
            _VP, _I, _I, _VP, _VP, _VP, _VP, _VP, _D, _VP, _VP, _VP, _VP,
            _I, _D, _D]
        lib.fabric_bucket_colmax.argtypes = [_VP, _I, _I, _VP, _VP, _VP,
                                             _VP]
        lib.fabric_gather_add.argtypes = [_VP, _I, _VP, _VP, _VP, _VP]
        for fn in (lib.fabric_bucket_scan, lib.fabric_bucket_colmax,
                   lib.fabric_gather_add):
            fn.restype = _I
        lib.fabric_scan_error_string.argtypes = [_I]
        lib.fabric_scan_error_string.restype = ctypes.c_char_p
        _LIB["fabric_scan"] = lib
    return lib


def _launch(lib, fn, *args) -> None:
    rc = fn(*args)
    LAUNCHES["fabric_scan"] += 1
    if rc != 0:
        msg = lib.fabric_scan_error_string(rc).decode()
        raise RuntimeError(f"fabric_scan launch failed: CUDA error {rc}"
                           f" ({msg})")


def _need(t, dtype, numel, dev, what) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t)}")
    if t.device != dev or t.dtype != dtype or t.numel() != numel \
            or not t.is_contiguous():
        raise ValueError(
            f"{what}: need a contiguous {dtype} tensor of {numel} elements"
            f" on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_operands(ops: ScanOps, dev) -> None:
    """Device, dtype, contiguity and shape of every operand."""
    n = ops.n
    for name in ("t_ready", "c1", "c3", "rdv"):
        _need(getattr(ops, name), DTYPE, n, dev, name)
    for s, bks in enumerate(ops.stages):
        G = sum(b.G for b in bks)
        _need(ops.init[s], DTYPE, G, dev, f"stage-{s + 1} init")
        if sum(b.K * b.G for b in bks) != ops.sizes[s]:
            raise ValueError(f"stage-{s + 1} buckets do not fill its size")
        for b in bks:
            _need(b.ridx, torch.int32, b.K * b.G, dev, "release index")
            if (b.cidx is None) != (s == 1):
                raise ValueError(f"stage-{s + 1} cost index misplaced")
            if b.cidx is not None:
                _need(b.cidx, torch.int32, b.K * b.G, dev, "cost index")
            if b.mask is not None:
                _need(b.mask, torch.bool, b.K * b.G, dev, "mask")
    if not ops.finish:
        _need(ops.pos3, torch.int32, n, dev, "pos3")
        return
    F = ops.fperm.numel()
    _need(ops.fperm, torch.int32, F, dev, "fperm")
    _need(ops.foff, DTYPE, F, dev, "foff")
    for b in (*ops.fin_flows, *ops.fin_ranks):
        _need(b.idx, torch.int32, b.K * b.G, dev, "reduction index")
        if b.mask is not None:
            _need(b.mask, torch.bool, b.K * b.G, dev, "reduction mask")
    if sum(b.G for b in ops.fin_flows) != F \
            or sum(b.G for b in ops.fin_ranks) != ops.n_rank_out:
        raise ValueError("finish buckets do not cover flows and ranks")


def _ptr(t: Optional[torch.Tensor], offset: int = 0) -> Optional[int]:
    """Device address of element ``offset`` of ``t`` (None -> NULL)."""
    return None if t is None else t.data_ptr() + offset * t.element_size()


def fabric_scan(ops: ScanOps):
    """Advance one super-batch: the hand-written CUDA kernels of
    ``csrc/fabric_scan.cu`` for operands on the card, the plain version
    :func:`fabric_scan_ref` for operands on the CPU.

    Replaces the Pallas kernel built by the JAX package's
    ``core/fabric_pallas.py:_build_call``.  On the H100 it is bound by
    bytes moved (about 100 bytes per wire message: four float64 columns,
    the int32 bucket indices and the three stage scan vectors) and by
    the serial chain depth of each stage (24 VCI, 48 NIC and 8 wire
    steps per resource in the 32k-rank partitioned record).  The design
    gives every segment of a bucket one thread that walks its column
    down the depth axis, so each step's reads of row k are coalesced
    across neighbouring segments and the chain depth is the only serial
    work; one launch per bucket, in stage order, on PyTorch's current
    stream and without synchronisation, orders the cross-segment gathers
    between stages.  Returns what :func:`fabric_scan_ref` returns.
    """
    dev = ops.t_ready.device
    if dev.type == "cpu":
        return fabric_scan_ref(ops)
    if dev.type != "cuda":
        raise ValueError(f"fabric_scan: unsupported device {dev}")
    _check_operands(ops, dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ys = [torch.empty(s, dtype=DTYPE, device=dev) for s in ops.sizes]
    carry = None if ops.finish else [torch.empty_like(a) for a in ops.init]
    srcs = (ops.t_ready, ys[0], ys[1])
    costs = (ops.c1, None, ops.c3)
    for s, bks in enumerate(ops.stages):
        for b in bks:
            _launch(lib, lib.fabric_bucket_scan, stream, b.K, b.G,
                    _ptr(srcs[s]), _ptr(b.ridx),
                    _ptr(ops.rdv) if s == 2 else None,
                    _ptr(costs[s]), _ptr(b.cidx),
                    ops.alpha_nic if s == 1 else 0.0, _ptr(b.mask),
                    _ptr(ops.init[s], b.go), _ptr(ys[s], b.fo),
                    None if carry is None else _ptr(carry[s], b.go),
                    int(s == 2), ops.alpha_wire, ops.alpha_recv)
    if not ops.finish:
        arr = torch.empty(ops.n, dtype=DTYPE, device=dev)
        _launch(lib, lib.fabric_gather_add, stream, ops.n, _ptr(ys[2]),
                _ptr(ops.pos3), None, _ptr(arr))
        return (arr, *carry)
    F = ops.fperm.numel()
    fmb = torch.empty(F, dtype=DTYPE, device=dev)
    for b in ops.fin_flows:
        _launch(lib, lib.fabric_bucket_colmax, stream, b.K, b.G,
                _ptr(ys[2]), _ptr(b.idx), _ptr(b.mask), _ptr(fmb, b.go))
    fin = torch.empty(F, dtype=DTYPE, device=dev)
    _launch(lib, lib.fabric_gather_add, stream, F, _ptr(fmb),
            _ptr(ops.fperm), _ptr(ops.foff), _ptr(fin))
    rank_out = torch.empty(ops.n_rank_out, dtype=DTYPE, device=dev)
    for b in ops.fin_ranks:
        _launch(lib, lib.fabric_bucket_colmax, stream, b.K, b.G,
                _ptr(fin), _ptr(b.idx), _ptr(b.mask), _ptr(rank_out, b.go))
    return rank_out


# ---------------------------------------------------------------------------
# Super-batch assembly (host side)
# ---------------------------------------------------------------------------

def _assemble(items: List[GridItem],
              finishes: Optional[List[FinishSpec]]
              ) -> Tuple[ScanOps, dict]:
    """Flatten one cfg-uniform bucket of grid items into the kernels'
    operands (host arrays).  Per-item stage layouts (memoized, shared
    with the torch engine) compose by message-base offset — no global
    argsort; only the finish reduction's flow/rank groupings sort
    globally.  Returns ``(ops, aux)``, ``aux`` holding the host-side
    unpack info."""
    N = sum(len(it) for it in items)
    tr = np.empty(N)
    c1 = np.empty(N)
    c3 = np.empty(N)
    rdv = np.empty(N)
    st_orders: Tuple[list, ...] = ([], [], [])
    st_counts: Tuple[list, ...] = ([], [], [])
    st_offs: Tuple[list, ...] = ([], [], [])
    fid_l, foff_l, fdst_l, item_ranks = [], [], [], []
    item_lens = []
    base = fbase = rbase = 0
    for k, it in enumerate(items):
        n = len(it)
        sl = slice(base, base + n)
        lays = _raw_layouts(it.src, it.dst, it.vci % it.n_vcis,
                            it.n_vcis, it.n_ranks, it.key)
        tr[sl] = it.t_ready
        c1[sl], c3[sl], rdv[sl] = _cost_columns(
            it.t_ready, it.nbytes, it.thread, it.put, it.am_copy,
            it.cfg, lays[0], None)
        for s in range(3):
            o, _, cnt, f = lays[s]
            st_orders[s].append(o + base)
            st_counts[s].append(cnt)
            st_offs[s].append(f + base)
        if finishes is not None:
            fin = finishes[k]
            fid_l.append(fin.fid + fbase)
            foff_l.append(fin.foff)
            fdst_l.append(fin.fdst + rbase)
            item_ranks.append((rbase, fin.n_ranks))
            fbase += len(fin.foff)
            rbase += fin.n_ranks
        item_lens.append(n)
        base += n
    stages = []
    for s in range(3):
        stages.append(_stage_buckets(np.concatenate(st_orders[s]),
                                     np.concatenate(st_counts[s]),
                                     np.concatenate(st_offs[s]), N))
    (b1, pos1, s1), (b2, pos2, s2), (b3, pos3, s3) = stages
    scan_stages, grp_orders = _pack_stage_ops(b1, b2, b3, pos1, pos2)
    ops = _set_costs(ScanOps(
        t_ready=tr, c1=c1, c3=c3, rdv=rdv,
        init=tuple(np.zeros(len(g)) for g in grp_orders),
        alpha_wire=0.0, alpha_nic=0.0, alpha_recv=0.0,
        stages=scan_stages, sizes=(s1, s2, s3)), items[0].cfg)
    aux: dict = {"item_lens": item_lens, "grp_orders": tuple(grp_orders)}
    if finishes is None:
        return dataclasses.replace(ops, pos3=pos3.astype(np.int32)), aux
    fid = np.concatenate(fid_l)
    foff = np.concatenate(foff_l)
    fdst = np.concatenate(fdst_l)
    F = len(foff)
    of, uf, cf, ff = _fb._group_layout(fid)
    if len(uf) != F:
        raise ValueError("every flow needs at least one wire message")
    fbuckets, _, _ = _stage_buckets(of, cf, ff, N)
    fperm = np.empty(F, dtype=np.int32)
    go = 0
    for bk in fbuckets:
        G = bk.idx.shape[1]
        fperm[uf[bk.sel]] = go + np.arange(G, dtype=np.int32)
        go += G
    orr, ur, cr, fr = _fb._group_layout(fdst)
    rbuckets, _, _ = _stage_buckets(orr, cr, fr, F)
    aux.update(rank_out_ids=np.concatenate([ur[bk.sel] for bk in rbuckets]),
               item_ranks=item_ranks, n_ranks_total=rbase)
    ops = dataclasses.replace(
        ops, fin_flows=tuple(_reduce_buckets(fbuckets, lambda i: pos3[i])),
        fperm=fperm, foff=foff,
        # values are flow ids: the rank reduction gathers per-flow times
        fin_ranks=tuple(_reduce_buckets(rbuckets, lambda i: i)),
        n_rank_out=sum(bk.idx.shape[1] for bk in rbuckets))
    return ops, aux


# Whole-super-batch operands (device-resident), keyed by mode, device,
# dtype and the member items' layout keys: benchmark repeats re-launch
# the kernels without re-assembling or re-copying anything.
_OPS_MEMO = _fb.CappedMemo(8)
# Single-batch arrivals-mode structure (stage buckets + index operands)
# for the warm-state driver path, keyed by device, dtype and layout key.
_ARR_MEMO = _fb.CappedMemo(32)


def clear_memos() -> None:
    """Reset the cuda engine's operand caches with their counters."""
    _OPS_MEMO.clear()
    _ARR_MEMO.clear()


def grid_ops(items: List[GridItem], finishes: Optional[List[FinishSpec]],
             device="cuda") -> Tuple[ScanOps, dict]:
    """One cfg-uniform super-batch's device-resident operands (memoized)
    and its unpack info: the input :func:`fabric_scan` takes."""
    dev = resolve_device(device)
    mode = "finish" if finishes is not None else "arrivals"
    key = None
    if all(it.key is not None for it in items):
        key = ("cuda-" + mode, str(dev), str(DTYPE),
               tuple(it.key for it in items))
    entry = _OPS_MEMO.get(key)
    if entry is None:
        ops, aux = _assemble(items, finishes)
        entry = (_upload(ops, dev), aux)
        _OPS_MEMO.put(key, entry)
    return entry


def _cfg_buckets(items: List[GridItem]) -> Dict[tuple, List[int]]:
    """Items bucketed by (cfg, n_ranks, n_vcis): each bucket's NetConfig
    is uniform (one set of cost scalars), and keeping rank-grid shapes
    uniform keeps each bucket's per-resource chain depths nearly uniform
    too, so the exact-depth (mask-free) scan buckets stay under
    :data:`MAX_EXACT_DEPTHS`."""
    buckets: Dict[tuple, List[int]] = {}
    for i, it in enumerate(items):
        buckets.setdefault((it.cfg, it.n_ranks, it.n_vcis), []).append(i)
    return buckets


def transmit_grid(items: List[GridItem], device="cuda") -> List[np.ndarray]:
    """Evaluate many independent cold-start exchanges through the
    kernels; returns each item's per-message arrival times in its input
    (merge) order.  Used for points without an affine finish."""
    out: List[Optional[np.ndarray]] = [None] * len(items)
    for members in _cfg_buckets(items).values():
        ops, aux = grid_ops([items[i] for i in members], None, device)
        arr = fabric_scan(ops)[0].cpu().numpy()
        o = 0
        for ln, i in zip(aux["item_lens"], members):
            out[i] = arr[o:o + ln]
            o += ln
    return out  # type: ignore[return-value]


def transmit_grid_finish(items: List[GridItem], finishes: List[FinishSpec],
                         device="cuda") -> List[np.ndarray]:
    """Evaluate many cold-start exchanges *and their finish reductions*
    on the device; returns each item's per-rank completion times (ranks
    receiving no flow complete at 0.0, as in the host-side reduction).
    Device-to-host traffic shrinks from one float per wire message to
    one per rank."""
    out: List[Optional[np.ndarray]] = [None] * len(items)
    for members in _cfg_buckets(items).values():
        ops, aux = grid_ops([items[i] for i in members],
                            [finishes[i] for i in members], device)
        full = np.zeros(aux["n_ranks_total"])
        full[aux["rank_out_ids"]] = fabric_scan(ops).cpu().numpy()
        for (rb, R), i in zip(aux["item_ranks"], members):
            out[i] = full[rb:rb + R]
    return out  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# The warm-state driver fabric
# ---------------------------------------------------------------------------

def _arr_structure(lays, n: int, device) -> Tuple[ScanOps, tuple]:
    """Stage buckets + device-resident index operands of one
    arrivals-mode batch (the warm driver path's per-layout structure
    cache entry); the per-call values are filled in by the caller."""
    stages = [_stage_buckets(lays[s][0], lays[s][2], lays[s][3], n)
              for s in range(3)]
    (b1, pos1, s1), (b2, pos2, s2), (b3, pos3, s3) = stages
    scan_stages, grp_orders = _pack_stage_ops(b1, b2, b3, pos1, pos2)
    zeros = np.zeros(n)
    ops = ScanOps(t_ready=zeros, c1=zeros, c3=zeros, rdv=zeros,
                  init=tuple(np.zeros(len(g)) for g in grp_orders),
                  alpha_wire=0.0, alpha_nic=0.0, alpha_recv=0.0,
                  stages=scan_stages, sizes=(s1, s2, s3),
                  pos3=pos3.astype(np.int32))
    return _upload(ops, device), tuple(grp_orders)


class CudaFabric(TorchFabric):
    """Kernel fabric: one super-batch of kernel launches per staged
    batch.

    Scalar state stays authoritative on the Python side exactly as in
    the torch engine — warm semantics (steady-state iterations,
    dependent RMA traffic between batches) are identical.  A staged
    batch folds the warm VCI owners into the host cost precompute,
    passes the per-resource busy-until clocks as the kernels' init
    vectors, and writes the carried-out clocks back.  Tiny or narrow
    batches take the same bit-identical scalar fallback as the other
    engines.
    """

    def transmit_arrays(self, t_ready, nbytes, vci, thread, put, am_copy,
                        src, dst, *, layout_key=None):
        n = t_ready.shape[0]
        if n == 0:
            return np.empty(0)
        per_src = np.bincount(src, minlength=self.n_ranks)
        if self._narrow(n, per_src):
            return self._transmit_scalar(t_ready, nbytes, vci, thread,
                                         put, am_copy, src, dst)
        vci = vci % self.n_vcis
        lays = _raw_layouts(src, dst, vci, self.n_vcis, self.n_ranks,
                            layout_key)
        skey = None
        if layout_key is not None:
            skey = ("cuda-arr", str(self.device), str(DTYPE), layout_key)
        entry = _ARR_MEMO.get(skey)
        if entry is None:
            entry = _arr_structure(lays, n, self.device)
            _ARR_MEMO.put(skey, entry)
        struct, grp_orders = entry

        order1, uniq1, counts1, offs1 = lays[0]
        banks = [(g // self.n_vcis, g % self.n_vcis)
                 for g in uniq1.tolist()]
        warm_prev = np.array([-1 if self.vci_last_thread[r][v] is None
                              else self.vci_last_thread[r][v]
                              for r, v in banks], dtype=np.int64)
        c1, c3, rdv = _cost_columns(t_ready, nbytes, thread, put, am_copy,
                                    self.cfg, lays[0], warm_prev)
        state1 = np.array([self.vci_free[r][v] for r, v in banks])
        ranks = lays[1][1].tolist()
        state2 = np.array([self.nic_free[r] for r in ranks])
        links = [(c // self.n_ranks, c % self.n_ranks)
                 for c in lays[2][1].tolist()]
        state3 = np.array([self.wire_free.get(sd, 0.0) for sd in links])

        def t(a):
            return torch.from_numpy(
                np.ascontiguousarray(a, dtype=np.float64)).to(self.device)
        ops = _set_costs(dataclasses.replace(
            struct, t_ready=t(t_ready), c1=t(c1), c3=t(c3), rdv=t(rdv),
            init=(t(state1[grp_orders[0]]), t(state2[grp_orders[1]]),
                  t(state3[grp_orders[2]]))), self.cfg)
        arr, cur1, cur2, cur3 = (x.cpu().numpy() for x in fabric_scan(ops))

        # warm state out: the carries are in bucket-group order; unsort
        # them back to each stage's group (resource) order
        s1o = np.empty(len(banks))
        s1o[grp_orders[0]] = cur1
        # a bank's final owner is its last queued message's thread — a
        # pure function of the (host-known) grouping, not of the times
        last_thread = np.asarray(thread)[order1[offs1 + counts1 - 1]]
        for (r, v), busy, owner in zip(banks, s1o.tolist(),
                                       last_thread.tolist()):
            self.vci_free[r][v] = busy
            self.vci_last_thread[r][v] = int(owner)
        s2o = np.empty(len(ranks))
        s2o[grp_orders[1]] = cur2
        for r, busy in zip(ranks, s2o.tolist()):
            self.nic_free[r] = busy
        s3o = np.empty(len(links))
        s3o[grp_orders[2]] = cur3
        self.wire_free.update(zip(links, s3o.tolist()))
        self._count_sent(n, per_src)
        return arr
