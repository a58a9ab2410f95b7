"""The CUDA fabric engine: the fused fabric kernel, written by hand for
Hopper, behind the same host-side super-batch assembly as the TPU engine.

Fourth engine of the port's fabric family (``engine="cuda"``), the
counterpart of the JAX package's ``core/fabric_pallas.py``.  It advances
the three-stage resource model — per-rank VCI banks, per-rank NIC,
per-directed-link wires — and the finish reduction with the one kernel
of ``csrc/fabric_scan.cu``, one launch per super-batch:

  * the whole grid of sweep points is flattened into one cfg-bucketed
    super-batch and laid out *source-rank-major*: every queue a message
    passes (VCI ``(src, vci)``, NIC ``src``, wire ``(src, dst)``)
    belongs to its source rank, so each *rank-record* — one grid item's
    messages from one rank, in merge order — is walked by one thread,
    independent of every other (:func:`_rank_layout`);
  * per-message stage-1 costs (previous-owner injection chain, protocol
    copy costs) are precomputed on the host in float64 with exactly the
    scalar engine's operation order, so the device work is nothing but
    the queue recurrences ``t[i] = max(r[i], t[i-1]) + c[i]`` and maxima;
  * the finish reduction (per-flow max arrival + affine finish offset,
    then the per-rank max) is one max per destination rank over the
    messages into it of ``arrival + foff[flow]``: ``fl(x + c)`` is
    monotonic in ``x``, so this equals the flow-max form bit for bit, in
    any order — a 32k-rank point returns 32768 floats instead of 1.6M
    arrivals.

The kernel's wrapper is :func:`fabric_scan`; its plain PyTorch version,
the same record walk as torch tensor steps, is :func:`fabric_scan_ref`.
The wrapper takes the plain version only for operands on the CPU; for
CUDA operands it launches the kernel or raises.

Precision contract (``repro_torch.compat.x64_mode``): under float64,
the default, bit-for-bit equal to ``ReferenceFabric`` (host costs in
float64 with the reference operation order; adding ``0.0`` is bitwise
identity; ``max`` reductions are order-independent).  Under float32 the
host costs are still computed in float64 and rounded once on upload, the
kernel's float32 build (``fabric_rank_scan_f32``) walks the same records
with single-precision adds, and the results are tolerance-close; the
float32 kernel is bit for bit equal to its plain version, as the
float64 one is.  The operand memos are keyed by the mode.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import compat
from . import fabric as _fb
from .fabric import NetConfig
from .fabric_torch import (GridItem, TorchFabric, _raw_layouts, float_dtype,
                           host64, resolve_device, upload)

# The kernel's launch shape and operand encoding (csrc/fabric_scan.cu):
THREADS = 128          # rank-records (threads) per block
WARP = 32
SMEM_DOUBLES = 6144    # VCI + link carries a block keeps in shared memory
                       # (slots of the mode's float: 48 KiB in float64,
                       # 24 KiB in float32, so layouts are mode-free)
VCI_LIMIT = 1 << 8     # slot word: VCI slot in bits 0-7,
LINK_LIMIT = 1 << 23   # link slot in bits 8-30,
RDV_BIT = 1 << 31      # the rendezvous flag in bit 31
# Columns of a record's descriptor (the kernel's ``Record``: 12 int32,
# the last one padding to 48 bytes).
M0, STRIDE, KW, TAIL, DEPTH, REC, CV0, NV, CL0, NL, SOFF = range(11)
DESC_FIELDS = 12


@dataclass
class FinishSpec:
    """Device-side finish reduction of one grid item.

    Valid only for *affine* finishes (``finish_batch(flows, None, x) ==
    x + foff`` elementwise — the caller probes this) with offsets >= 0:
    the kernel then takes, per destination rank, the max over the
    messages into it of arrival + ``foff`` of the message's flow, which
    is the per-flow max arrival + ``foff``, maxed per rank.
    """
    fid: np.ndarray    # (n,) flow id of each merge-ordered message
    foff: np.ndarray   # (F,) affine finish offset per flow
    fdst: np.ndarray   # (F,) destination rank per flow
    n_ranks: int


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
# The source-rank-major layout
# ---------------------------------------------------------------------------

def _item_records(lays, n_vcis: int, n_ranks: int):
    """One grid item's rank-records from its stage layouts.

    A record is one source rank's messages in merge order (the stage-2
    groups of ``lays``).  Its VCI carries are the stage-1 groups of that
    rank and its link carries the stage-3 groups, consecutive in their
    stages' group order, so a message's *slot* is its group's index
    minus the record's first group.  Returns ``(order, offs, depth, cv0,
    nv, cl0, nl, vslot, lslot)``: per record the message list in
    ``order[offs:offs + depth]`` and the carry ranges; per message (in
    input order) its two slots.
    """
    (o1, u1, n1, _), (o2, u2, n2, f2), (o3, u3, n3, _) = lays
    n = o2.shape[0]

    def group_of(order, counts):
        g = np.empty(n, dtype=np.int64)
        g[order] = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
        return g
    rec = group_of(o2, n2)
    cv0 = np.searchsorted(u1 // n_vcis, u2)
    cl0 = np.searchsorted(u3 // n_ranks, u2)
    nv = np.diff(np.append(cv0, len(u1)))
    nl = np.diff(np.append(cl0, len(u3)))
    return (o2, f2, n2, cv0, nv, cl0, nl, group_of(o1, n1) - cv0[rec],
            group_of(o3, n3) - cl0[rec])


def _positions(desc: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Where each record's messages lie: ``(rep, k, pos)`` over every
    (record, step) pair, record-major — record index, step and layout
    position (``m0 + stride * k`` while ``k < kw``, else ``tail + k -
    kw``)."""
    d = desc[:, DEPTH].astype(np.int64)

    def per_step(col):
        return np.repeat(desc[:, col].astype(np.int64), d)
    starts = np.zeros(len(d), dtype=np.int64)
    np.cumsum(d[:-1], out=starts[1:])
    rep = np.repeat(np.arange(len(d), dtype=np.int64), d)
    k = np.arange(rep.shape[0], dtype=np.int64) - np.repeat(starts, d)
    kw = per_step(KW)
    pos = np.where(k < kw, per_step(M0) + per_step(STRIDE) * k,
                   per_step(TAIL) + (k - kw))
    return rep, k, pos


@dataclass
class RankLayout:
    """Source-rank-major structure of one super-batch (host arrays, a
    pure function of the items' ``(src, dst, vci)`` columns)."""
    perm: np.ndarray    # (n,) message id at each layout position
    slot: np.ndarray    # (n,) uint32 VCI slot | link slot << 8
    desc: np.ndarray    # (R, DESC_FIELDS) int32, records in launch order
    cta: np.ndarray     # (C + 1,) int32 first record of each block
    smem: int           # doubles of shared memory a block takes
    sizes: tuple        # (VCI carries, records, link carries)


def _rank_layout(lays_list, n_vcis_list, n_ranks_list) -> RankLayout:
    """Lay a super-batch's items out for the kernel.

    Records go deepest first (the longest chains start first, and a
    warp's records have near-equal depths).  A block takes up to
    :data:`THREADS` consecutive records whose carries fit
    :data:`SMEM_DOUBLES` together; a record whose carries alone exceed
    that is rejected, as a rank with too many VCIs or links is.  Within
    each warp, message k of lane j lies at ``base + k * lanes + j`` up to
    the warp's least depth ``kw``, so a step's loads coalesce; each
    lane's further messages follow, lane after lane.
    """
    parts, mbase, b1, b3 = [], 0, 0, 0
    for lays, nvc, nrk in zip(lays_list, n_vcis_list, n_ranks_list):
        o, f, d, cv0, nv, cl0, nl, vs, ls = _item_records(lays, nvc, nrk)
        parts.append((o + mbase, f + mbase, d, cv0 + b1, nv, cl0 + b3, nl,
                      vs, ls))
        mbase += o.shape[0]
        b1 += len(lays[0][1])
        b3 += len(lays[2][1])
    order, offs, depth, cv0, nv, cl0, nl, vslot, lslot = (
        np.concatenate(c) for c in zip(*parts))
    n, R = order.shape[0], len(depth)
    if max(n, b1, b3) >= 2 ** 31:
        raise ValueError("super-batch too large for int32 indices")
    if R and (int(vslot.max()) >= VCI_LIMIT or int(lslot.max()) >= LINK_LIMIT):
        raise ValueError(f"a rank has more than {VCI_LIMIT} VCIs or"
                         f" {LINK_LIMIT} links")
    if R and int((nv + nl).max()) > SMEM_DOUBLES:
        raise ValueError(f"a rank-record has more than {SMEM_DOUBLES} VCI"
                         f" and link carries")
    srt = np.argsort(-depth, kind="stable")
    d = depth[srt]
    cs = np.zeros(R + 1, dtype=np.int64)
    np.cumsum((nv + nl)[srt], out=cs[1:])
    firsts = [0]
    while firsts[-1] < R:
        a = firsts[-1]
        fit = int(np.searchsorted(cs, cs[a] + SMEM_DOUBLES, side="right")) - 1
        firsts.append(max(a + 1, min(a + THREADS, fit)))
    cta = np.asarray(firsts, dtype=np.int64)
    blk = np.repeat(np.arange(len(cta) - 1), np.diff(cta))
    t = np.arange(R, dtype=np.int64) - cta[blk]
    g0 = cta[blk] + (t // WARP) * WARP       # first record of the warp
    lanes = np.minimum(WARP, cta[blk + 1] - g0)
    lane = t % WARP
    kw = d[g0 + lanes - 1]                   # the warp's least depth
    cd = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(d, out=cd[1:])
    desc = np.zeros((R, DESC_FIELDS), dtype=np.int64)
    desc[:, M0] = cd[g0] + lane
    desc[:, STRIDE] = lanes
    desc[:, KW] = kw
    desc[:, TAIL] = cd[g0] + kw * lanes + (cd[:-1] - cd[g0]) - kw * lane
    desc[:, DEPTH] = d
    desc[:, REC] = srt
    desc[:, CV0], desc[:, NV] = cv0[srt], nv[srt]
    desc[:, CL0], desc[:, NL] = cl0[srt], nl[srt]
    desc[:, SOFF] = cs[:-1] - cs[cta[blk]]
    rep, k, pos = _positions(desc)
    perm = np.empty(n, dtype=np.int64)
    perm[pos] = order[offs[srt][rep] + k]
    slot = (vslot | (lslot << 8))[perm].astype(np.uint32)
    smem = int((cs[cta[1:]] - cs[cta[:-1]]).max()) if R else 0
    return RankLayout(perm=perm, slot=slot, desc=desc.astype(np.int32),
                      cta=cta.astype(np.int32), smem=smem, sizes=(b1, R, b3))


# ---------------------------------------------------------------------------
# The kernel's operands
# ---------------------------------------------------------------------------

@dataclass
class ScanOps:
    """Everything one super-batch hands the kernel, per layout position
    (:class:`RankLayout`).  Held as NumPy arrays while assembled and as
    tensors on the target device once uploaded (:func:`_upload`)."""
    t_ready: object             # (n,) float64 on the host; on the
                                #   device in the mode's float
    c1: object                  # (n,) stage-1 costs
    c3: object                  # (n,) wire service times
    slot: object                # (n,) int32 VCI | link << 8 | rdv << 31
    out: object                 # (n,) int32 finish: output rank;
                                #   arrivals: message id
    desc: object                # (R, DESC_FIELDS) int32
    cta: object                 # (C + 1,) int32
    smem: int
    sizes: tuple                # (VCI carries, records, link carries)
    alpha_wire: float = 0.0
    alpha_nic: float = 0.0
    alpha_recv: float = 0.0
    rdv_add: float = 0.0        # the rendezvous round trip, 2 alpha_wire
    init: Optional[tuple] = None  # warm busy-until clocks per carry
                                # (stage group order); None: cold
    foff: object = None         # finish: (n,) offset per message
    n_out: int = 0              # finish: ranks in the output
    # the wrapper's checked launch arguments, made at the first launch
    # (``dataclasses.replace`` gives a new super-batch without them)
    launch: Optional[tuple] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def finish(self) -> bool:
        return self.foff is not None

    @property
    def n(self) -> int:
        return self.t_ready.shape[0]


def _set_costs(ops: ScanOps, cfg: NetConfig) -> ScanOps:
    """The scalar costs, rounded to the mode's float (exact in float64),
    so the kernel and its plain version add the same values."""
    rnd = float if compat.x64_enabled() else (lambda x: float(np.float32(x)))
    return dataclasses.replace(
        ops, alpha_wire=rnd(cfg.alpha_wire), alpha_nic=rnd(cfg.alpha_nic),
        alpha_recv=rnd(cfg.alpha_recv), rdv_add=rnd(2.0 * float(cfg.alpha_wire)))


def _slot_words(slot: np.ndarray, rdv: np.ndarray) -> np.ndarray:
    """The kernel's slot words: structure plus each message's rendezvous
    flag (``rdv`` per layout position, 0.0 where none is paid)."""
    return (slot | np.where(rdv != 0.0, np.uint32(RDV_BIT), np.uint32(0))
            ).view(np.int32)


def _check_indices(ops: ScanOps) -> None:
    """Every host index, checked before upload: the kernel trusts them.
    The records' positions cover the layout once, each slot lies within
    its record's carries, and each block's records fit its shared
    memory."""
    n = ops.n
    (G1, R, G3), desc = ops.sizes, ops.desc.astype(np.int64)
    if max(n, G1, G3) >= 2 ** 31:
        raise ValueError("super-batch too large for int32 indices")
    if desc.shape != (R, DESC_FIELDS) or np.any(desc[:, DEPTH] < 1) \
            or int(desc[:, DEPTH].sum()) != n:
        raise ValueError("record depths do not cover the messages")
    if not np.array_equal(np.sort(desc[:, REC]), np.arange(R)):
        raise ValueError("record carry index outside [0, records)")
    for lo, cnt, hi, what in ((CV0, NV, G1, "VCI"), (CL0, NL, G3, "link")):
        if np.any(desc[:, lo] < 0) or np.any(desc[:, lo] + desc[:, cnt] > hi):
            raise ValueError(f"record {what} carries outside [0, {hi})")
    rep, _, pos = _positions(desc)
    if pos.size and (pos.min() < 0 or pos.max() >= n):
        raise ValueError(f"record position outside [0, {n})")
    seen = np.zeros(n, dtype=bool)
    seen[pos] = True
    if not seen.all():
        raise ValueError("record positions do not cover the layout once")
    word = ops.slot[pos].view(np.uint32)
    if np.any((word & 0xFF) >= desc[rep, NV]) \
            or np.any(((word >> 8) & (LINK_LIMIT - 1)) >= desc[rep, NL]):
        raise ValueError("slot index outside its record's carries")
    hi = ops.n_out if ops.finish else n
    if n and (int(ops.out.min()) < 0 or int(ops.out.max()) >= hi):
        raise ValueError(f"output index outside [0, {hi})")
    cta = ops.cta.astype(np.int64)
    if cta[0] != 0 or cta[-1] != R or np.any(np.diff(cta) < 1) \
            or np.any(np.diff(cta) > THREADS):
        raise ValueError(f"blocks must take 1 to {THREADS} records each")
    if ops.smem > SMEM_DOUBLES or np.any(desc[:, SOFF] < 0) or \
            np.any(desc[:, SOFF] + desc[:, NV] + desc[:, NL] > ops.smem):
        raise ValueError("record carries outside the block's shared memory")


def _upload(ops: ScanOps, device) -> ScanOps:
    """Copy an assembled super-batch's arrays to ``device``, the float
    columns in the mode's dtype."""
    _check_indices(ops)

    def t(a):
        if a is None:
            return None
        return upload(a, device)
    return dataclasses.replace(
        ops, t_ready=t(ops.t_ready), c1=t(ops.c1), c3=t(ops.c3),
        slot=t(ops.slot), out=t(ops.out), desc=t(ops.desc), cta=t(ops.cta),
        foff=t(ops.foff),
        init=None if ops.init is None else tuple(t(a) for a in ops.init))


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------

def rank_max(n_out: int, dst: torch.Tensor, vals: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The finish reduction: ``out[r]`` is the max of ``vals`` into rank
    ``r``, 0.0 where none arrives.  Max is exact and order-free, so any
    order of the messages gives the same bits."""
    if out is None:
        out = vals.new_zeros(n_out)
    return out.scatter_reduce_(0, dst.long(), vals, "amax")


# Below this many active records the plain version walks each of them
# on host floats: a torch step costs more than that many scalar steps.
LONE_RECORDS = 32


def _walk_alone(ops: ScanOps, p: torch.Tensor, vci: list, nic: float,
                wire: list) -> Tuple[float, list]:
    """One record's steps at positions ``p`` on host floats (Python's
    float is an IEEE double, its ``max`` and ``+`` those of the float64
    kernel; in float32, NumPy's ``float32`` scalars, whose ``+`` rounds
    as the float32 kernel's), one message at a time.  ``vci`` and
    ``wire`` are the record's carries, updated in place.  Returns the
    NIC carry and the arrivals (plus offsets in finish mode)."""
    cols = [ops.t_ready[p], ops.c1[p], ops.c3[p], ops.slot[p]]
    if ops.finish:
        cols.append(ops.foff[p])
    if ops.t_ready.dtype == torch.float32:
        f = np.float32
        vci[:], wire[:] = map(f, vci), map(f, wire)
        nic = f(nic)
        ops = dataclasses.replace(
            ops, alpha_nic=f(ops.alpha_nic), rdv_add=f(ops.rdv_add),
            alpha_wire=f(ops.alpha_wire), alpha_recv=f(ops.alpha_recv))
    out = []
    for tr, c1, c3, s, *fo in zip(*(
            list(c.cpu().numpy()) if c.dtype == torch.float32 else c.tolist()
            for c in cols)):
        v, li = s & 0xFF, (s >> 8) & (LINK_LIMIT - 1)
        t1 = max(tr, vci[v]) + c1
        vci[v] = t1
        nic = t2 = max(t1, nic) + ops.alpha_nic
        if s < 0:
            t2 = t2 + ops.rdv_add
        t3 = max(t2, wire[li]) + c3
        wire[li] = t3
        a = (t3 + ops.alpha_wire) + ops.alpha_recv
        out.append(a + fo[0] if fo else a)
    return float(nic), out


def fabric_scan_ref(ops: ScanOps):
    """The fused fabric kernel's plain PyTorch version.

    Walks the same records with the same IEEE-754 operations as the
    kernel — a Python loop down the depth axis, vectorized over the
    records still active at each step (the deepest come first, so they
    are a prefix); once at most :data:`LONE_RECORDS` remain, each walks
    its remaining steps on host floats (:func:`_walk_alone`).  Finish
    mode returns the ``(n_out,)`` per-rank times; arrivals mode returns
    ``(arrivals (n,), carry1, carry2, carry3)``, each stage's busy-until
    clocks per group in stage group order, the wire carries without the
    delivery tail.
    """
    dev, dt = ops.t_ready.device, ops.t_ready.dtype
    R = ops.sizes[1]
    desc = ops.desc.long()
    m0, stride, kw, tail, _, rec, cv0, nv, cl0, nl = \
        desc[:, :NL + 1].unbind(1)
    d = ops.desc[:, DEPTH].cpu().numpy()
    n_act = R - np.searchsorted(d[::-1], np.arange(int(d.max()) if R else 0),
                                side="right")
    vectorized = int(np.count_nonzero(n_act > LONE_RECORDS))
    if ops.init is None:
        vci, nic, wire = (torch.zeros(s, dtype=dt, device=dev)
                          for s in ops.sizes)
    else:
        vci, nic, wire = (a.clone() for a in ops.init)
    nic_l = nic[rec]
    slot = ops.slot.long()
    arr = None if ops.finish else torch.empty(ops.n, dtype=dt, device=dev)
    rank_out = rank_max(ops.n_out, ops.out[:0], ops.t_ready[:0]) \
        if ops.finish else None

    def emit(p, arrival):
        if ops.finish:
            rank_max(ops.n_out, ops.out[p], arrival, rank_out)
        else:
            arr[ops.out[p].long()] = arrival
    for k, a in enumerate(n_act[:vectorized].tolist()):
        p = torch.where(k < kw[:a], m0[:a] + stride[:a] * k,
                        tail[:a] + (k - kw[:a]))
        s = slot[p]
        vi = cv0[:a] + (s & 0xFF)
        li = cl0[:a] + ((s >> 8) & (LINK_LIMIT - 1))
        t1 = torch.maximum(ops.t_ready[p], vci[vi]) + ops.c1[p]
        vci[vi] = t1
        t2 = torch.maximum(t1, nic_l[:a]) + ops.alpha_nic
        nic_l[:a] = t2
        t2 = torch.where(s < 0, t2 + ops.rdv_add, t2)
        t3 = torch.maximum(t2, wire[li]) + ops.c3[p]
        wire[li] = t3
        arrival = (t3 + ops.alpha_wire) + ops.alpha_recv
        emit(p, arrival + ops.foff[p] if ops.finish else arrival)
    for i in range(int(n_act[vectorized]) if vectorized < len(n_act) else 0):
        ks = torch.arange(vectorized, int(d[i]), device=dev)
        p = torch.where(ks < kw[i], m0[i] + stride[i] * ks,
                        tail[i] + (ks - kw[i]))
        v0, w0 = int(cv0[i]), int(cl0[i])
        vl = vci[v0:v0 + int(nv[i])].tolist()
        wl = wire[w0:w0 + int(nl[i])].tolist()
        nic_l[i], vals = _walk_alone(ops, p, vl, float(nic_l[i]), wl)
        vci[v0:v0 + len(vl)] = torch.tensor(vl, dtype=dt)
        wire[w0:w0 + len(wl)] = torch.tensor(wl, dtype=dt)
        emit(p, torch.tensor(vals, dtype=dt, device=dev))
    if ops.finish:
        return rank_out
    nic[rec] = nic_l
    return arr, vci, nic, wire


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------

# Launch count of the hand-written kernel: one per launch the wrapper
# makes (one per super-batch), and nowhere else; ``fabric_scan`` counts
# both builds, ``fabric_scan_f64`` and ``fabric_scan_f32`` each one.
LAUNCHES = {"fabric_scan": 0, "fabric_scan_f64": 0, "fabric_scan_f32": 0}
# The library's entry point of each build, by the operands' float dtype.
ENTRY = {torch.float64: "fabric_rank_scan", torch.float32:
         "fabric_rank_scan_f32"}

_LIB: Dict[str, ctypes.CDLL] = {}
_VP, _I, _D, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, \
    ctypes.c_longlong


def _library() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/fabric_scan.cu``."""
    lib = _LIB.get("fabric_scan")
    if lib is None:
        from ..kernels import build
        lib = build.load("fabric_scan")
        for name in ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [
                _VP, _I, _I, _I, *[_VP] * 11, _D, _D, _D, _D, *[_VP] * 5, _LL]
            fn.restype = _I
        lib.fabric_scan_error_string.argtypes = [_I]
        lib.fabric_scan_error_string.restype = ctypes.c_char_p
        _LIB["fabric_scan"] = lib
    return lib


def _need(t, dtype, shape, dev, what) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t)}")
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{what}: need a contiguous {dtype} tensor of shape {shape}"
            f" on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_operands(ops: ScanOps, dev) -> None:
    """Device, dtype, contiguity and shape of every operand: the float
    operands all float64 or all float32, the build that runs."""
    n, R = ops.n, ops.sizes[1]
    dt = getattr(ops.t_ready, "dtype", None)
    if dt not in ENTRY:
        raise ValueError(f"t_ready: need float64 or float32, got {dt}")
    for name in ("t_ready", "c1", "c3"):
        _need(getattr(ops, name), dt, (n,), dev, name)
    _need(ops.slot, torch.int32, (n,), dev, "slot")
    _need(ops.out, torch.int32, (n,), dev, "out")
    _need(ops.desc, torch.int32, (R, DESC_FIELDS), dev, "desc")
    if not isinstance(ops.cta, torch.Tensor) or ops.cta.dim() != 1:
        raise ValueError("cta: need a 1-D tensor of block starts")
    _need(ops.cta, torch.int32, (ops.cta.numel(),), dev, "cta")
    if ops.init is not None:
        for a, size, what in zip(ops.init, ops.sizes, ("VCI", "NIC", "link")):
            _need(a, dt, (size,), dev, f"{what} init")
    if ops.finish:
        _need(ops.foff, dt, (n,), dev, "foff")
    if not 0 <= ops.smem <= SMEM_DOUBLES:
        raise ValueError(f"smem: {ops.smem} doubles, at most {SMEM_DOUBLES}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """Device address of ``t`` (None -> NULL)."""
    return None if t is None else t.data_ptr()


def fabric_scan(ops: ScanOps):
    """Advance one super-batch: the hand-written CUDA kernel of
    ``csrc/fabric_scan.cu`` for operands on the card, the plain version
    :func:`fabric_scan_ref` for operands on the CPU.

    Replaces the Pallas kernel built by the JAX package's
    ``core/fabric_pallas.py:_build_call``.  The operands' float dtype
    picks the build: float64 (``fabric_rank_scan``) or float32
    (``fabric_rank_scan_f32``).  On the H100 it is bound by bytes moved
    (40 bytes per wire message in finish mode in float64: three float
    columns, the slot word, the output slot and the finish offset; 24
    in float32) and by the serial chain of the deepest rank-record.  One thread walks
    each rank-record through all three queues and the finish, with its
    carries in shared memory, so the whole super-batch is one launch on
    PyTorch's current stream, without synchronisation; the per-rank
    output is zeroed by a memset inside the same call.  Returns what
    :func:`fabric_scan_ref` returns.
    """
    dev = ops.t_ready.device
    if dev.type == "cpu":
        return fabric_scan_ref(ops)
    if dev.type != "cuda":
        raise ValueError(f"fabric_scan: unsupported device {dev}")
    lib = _library()
    dt = ops.t_ready.dtype
    if ops.launch is None or ops.launch[0] != dev:  # once per super-batch
        _check_operands(ops, dev)
        i1, i2, i3 = (None, None, None) if ops.init is None else ops.init
        ops.launch = (dev, (
            int(ops.finish), ops.cta.numel() - 1, ops.smem, _ptr(ops.cta),
            _ptr(ops.desc), _ptr(ops.t_ready), _ptr(ops.c1), _ptr(ops.c3),
            _ptr(ops.slot), _ptr(ops.out), _ptr(ops.foff), _ptr(i1),
            _ptr(i2), _ptr(i3), ops.alpha_nic, ops.rdv_add,
            ops.alpha_wire, ops.alpha_recv))
    args = ops.launch[1]

    def empty(size):
        return torch.empty(size, dtype=dt, device=dev)
    if ops.finish:
        arr = o1 = o2 = o3 = None
        rank_out = empty(ops.n_out)
    else:
        arr, o1, o2, o3 = empty(ops.n), *(empty(g) for g in ops.sizes)
        rank_out = None
    rc = getattr(lib, ENTRY[dt])(
        torch.cuda.current_stream(dev).cuda_stream, *args, _ptr(arr),
        _ptr(o1), _ptr(o2), _ptr(o3), _ptr(rank_out), ops.n_out)
    n_cta = args[1]
    if n_cta:
        LAUNCHES["fabric_scan"] += 1
        LAUNCHES["fabric_scan_f64" if dt == torch.float64
                 else "fabric_scan_f32"] += 1
    if rc != 0:
        msg = lib.fabric_scan_error_string(rc).decode()
        raise RuntimeError(f"fabric_scan launch failed: CUDA error {rc}"
                           f" ({msg})")
    return rank_out if ops.finish else (arr, o1, o2, o3)


# ---------------------------------------------------------------------------
# Super-batch assembly (host side)
# ---------------------------------------------------------------------------

def _assemble(items: List[GridItem],
              finishes: Optional[List[FinishSpec]]
              ) -> Tuple[ScanOps, dict]:
    """Flatten one cfg-uniform bucket of grid items into the kernel's
    operands (host arrays).  Per-item stage layouts (memoized, shared
    with the torch engine) give each item's rank-records; the per-call
    values are permuted into the layout once, here.  Returns ``(ops,
    aux)``, ``aux`` holding the host-side unpack info."""
    N = sum(len(it) for it in items)
    tr, c1, c3, rdv = (np.empty(N) for _ in range(4))
    lays_list, item_lens, item_ranks = [], [], []
    fid_l, foff_l, fdst_l = [], [], []
    base = fbase = rbase = 0
    for k, it in enumerate(items):
        n = len(it)
        sl = slice(base, base + n)
        lays = _raw_layouts(it.src, it.dst, it.vci % it.n_vcis,
                            it.n_vcis, it.n_ranks, it.key)
        lays_list.append(lays)
        tr[sl] = it.t_ready
        c1[sl], c3[sl], rdv[sl] = _cost_columns(
            it.t_ready, it.nbytes, it.thread, it.put, it.am_copy,
            it.cfg, lays[0], None)
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
    lay = _rank_layout(lays_list, [it.n_vcis for it in items],
                       [it.n_ranks for it in items])
    perm = lay.perm
    ops = _set_costs(ScanOps(
        t_ready=tr[perm], c1=c1[perm], c3=c3[perm],
        slot=_slot_words(lay.slot, rdv[perm]), out=perm.astype(np.int32),
        desc=lay.desc, cta=lay.cta, smem=lay.smem, sizes=lay.sizes),
        items[0].cfg)
    if finishes is None:
        return ops, {"item_lens": item_lens}
    fid = np.concatenate(fid_l)[perm]
    foff = np.concatenate(foff_l)
    if np.any(np.bincount(fid, minlength=len(foff)) == 0):
        raise ValueError("every flow needs at least one wire message")
    if np.any(foff < 0):  # the kernel's max orders bit patterns
        raise ValueError("finish offsets must be >= 0")
    ops = dataclasses.replace(
        ops, out=np.concatenate(fdst_l)[fid].astype(np.int32),
        foff=foff[fid], n_out=rbase)
    return ops, {"item_ranks": item_ranks, "n_ranks_total": rbase}


# Whole-super-batch operands (device-resident), keyed by mode, device,
# precision mode and the member items' layout keys: benchmark repeats re-launch
# the kernel without re-assembling or re-copying anything.
_OPS_MEMO = _fb.CappedMemo(8)
# Single-batch arrivals-mode structure (layout + index operands) for the
# warm-state driver path, keyed by device, precision mode and layout key.
_ARR_MEMO = _fb.CappedMemo(32)


def memo_stats() -> dict:
    """Hit/miss counters of the super-batch operand memo and the
    arrivals-mode structure memo."""
    return {"grid_ops": _OPS_MEMO.stats(), "arrivals": _ARR_MEMO.stats()}


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
        key = ("cuda-" + mode, str(dev), compat.x64_enabled(),
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
    uniform keeps the records' depths, and so the warps' loads, uniform
    too."""
    buckets: Dict[tuple, List[int]] = {}
    for i, it in enumerate(items):
        buckets.setdefault((it.cfg, it.n_ranks, it.n_vcis), []).append(i)
    return buckets


def transmit_grid(items: List[GridItem], device="cuda") -> List[np.ndarray]:
    """Evaluate many independent cold-start exchanges through the
    kernel; returns each item's per-message arrival times in its input
    (merge) order.  Used for points without an affine finish."""
    out: List[Optional[np.ndarray]] = [None] * len(items)
    for members in _cfg_buckets(items).values():
        ops, aux = grid_ops([items[i] for i in members], None, device)
        arr = host64(fabric_scan(ops)[0])
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
        full = host64(fabric_scan(ops))
        for (rb, R), i in zip(aux["item_ranks"], members):
            out[i] = full[rb:rb + R]
    return out  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# The warm-state driver fabric
# ---------------------------------------------------------------------------

def _arr_structure(lays, n_vcis: int, n_ranks: int, device
                   ) -> Tuple[ScanOps, np.ndarray, np.ndarray]:
    """The layout and device-resident index operands of one
    arrivals-mode batch (the warm driver path's per-layout structure
    cache entry), with the host permutation and slot structure; the
    per-call values are filled in by the caller."""
    lay = _rank_layout([lays], [n_vcis], [n_ranks])
    n = lay.perm.shape[0]
    zeros = np.zeros(n)
    ops = ScanOps(t_ready=zeros, c1=zeros, c3=zeros,
                  slot=lay.slot.view(np.int32), out=lay.perm.astype(np.int32),
                  desc=lay.desc, cta=lay.cta, smem=lay.smem,
                  sizes=lay.sizes)
    return _upload(ops, device), lay.perm, lay.slot


class CudaFabric(TorchFabric):
    """Kernel fabric: one kernel launch per staged batch.

    Scalar state stays authoritative on the Python side exactly as in
    the torch engine — warm semantics (steady-state iterations,
    dependent RMA traffic between batches) are identical.  A staged
    batch folds the warm VCI owners into the host cost precompute,
    passes the per-resource busy-until clocks as the kernel's init
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
            skey = ("cuda-arr", str(self.device), compat.x64_enabled(),
                    layout_key)
        entry = _ARR_MEMO.get(skey)
        if entry is None:
            entry = _arr_structure(lays, self.n_vcis, self.n_ranks,
                                   self.device)
            _ARR_MEMO.put(skey, entry)
        struct, perm, slot = entry

        order1, uniq1, counts1, offs1 = lays[0]
        banks = [(g // self.n_vcis, g % self.n_vcis)
                 for g in uniq1.tolist()]
        warm_prev = np.array([-1 if self.vci_last_thread[r][v] is None
                              else self.vci_last_thread[r][v]
                              for r, v in banks], dtype=np.int64)
        c1, c3, rdv = _cost_columns(t_ready, nbytes, thread, put, am_copy,
                                    self.cfg, lays[0], warm_prev)
        ranks = lays[1][1].tolist()
        links = [(c // self.n_ranks, c % self.n_ranks)
                 for c in lays[2][1].tolist()]
        state = (np.array([self.vci_free[r][v] for r, v in banks]),
                 np.array([self.nic_free[r] for r in ranks]),
                 np.array([self.wire_free.get(sd, 0.0) for sd in links]))

        def t(a):
            return upload(a, self.device)
        ops = _set_costs(dataclasses.replace(
            struct, t_ready=t(np.asarray(t_ready, dtype=np.float64)[perm]),
            c1=t(c1[perm]), c3=t(c3[perm]), slot=t(_slot_words(slot, rdv[perm])),
            init=tuple(t(a.astype(np.float64)) for a in state)), self.cfg)
        arr, cur1, cur2, cur3 = (host64(x) for x in fabric_scan(ops))

        # warm state out, the carries in each stage's group order; a
        # bank's final owner is its last queued message's thread — a
        # pure function of the (host-known) grouping, not of the times
        last_thread = np.asarray(thread)[order1[offs1 + counts1 - 1]]
        for (r, v), busy, owner in zip(banks, cur1.tolist(),
                                       last_thread.tolist()):
            self.vci_free[r][v] = busy
            self.vci_last_thread[r][v] = int(owner)
        for r, busy in zip(ranks, cur2.tolist()):
            self.nic_free[r] = busy
        self.wire_free.update(zip(links, cur3.tolist()))
        self._count_sent(n, per_src)
        return arr
