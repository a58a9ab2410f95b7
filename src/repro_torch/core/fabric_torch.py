"""The torch fabric engine: stage scans as a torch loop over a padded
depth axis, plus a batched whole-grid path.

Third engine of the port's fabric family (``engine="torch"``), the
counterpart of the JAX package's ``core/fabric_jax.py``.  It implements
the same three-stage resource model as
:class:`repro_torch.core.fabric.Fabric` — per-rank VCI banks, per-rank
NIC, per-directed-link wires — but advances the grouped queue
recurrences as torch tensor steps over **fixed-shape padded segment
layouts**:

  * each stage's jagged groups are padded to a ``(depth, groups)``
    matrix (step-major: row k holds the k-th message of every group;
    depths and group counts rounded up to powers of two so nearby batch
    shapes share operand shapes; padded lanes are masked out of the
    carry, so padding never changes a value);
  * one :func:`_pipeline` call advances all three stages — a loop over
    the depth axis per stage, vectorized across groups and batched
    across grid items — with the protocol classification as selects;
  * the **grid path** (:func:`transmit_grid`) stacks many independent
    cold-start exchanges (sweep points) on a leading batch axis, one
    pipeline call per ``(n_ranks, n_vcis)`` bucket.

Precision contract (``repro_torch.compat.x64_mode``): under float64,
the default, bit-for-bit equal to ``ReferenceFabric``; under float32 the
same steps run in single precision, tolerance-close (about 1e-4
relative), the counters exact.  The per-message divisions (``nbytes /
beta_copy``, ``nbytes / beta``) are computed on the host in NumPy
float64 in both modes and cast to the mode's dtype on upload: PyTorch's
CUDA division by a host scalar multiplies by the reciprocal, which is
not the scalar engine's operation.  On the device the pipeline only
selects, takes maxima and adds, in the scalar engine's order.  Results
come back as float64 NumPy arrays in both modes, as the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from .. import compat
from . import fabric as _fb
from .fabric import Fabric, NetConfig, _group_layout


def float_dtype() -> torch.dtype:
    """The engines' float dtype in the active precision mode:
    ``torch.float64`` under ``compat.x64_mode(True)`` (the default),
    else ``torch.float32``."""
    return torch.float64 if compat.x64_enabled() else torch.float32


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device``; float arrays in the
    mode's dtype (:func:`float_dtype`), others as they are."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.is_floating_point():
        t = t.to(float_dtype())
    return t.to(device)


def host64(t: torch.Tensor) -> np.ndarray:
    """A device result as a host array, floats widened to float64."""
    t = t.cpu()
    return (t.double() if t.is_floating_point() else t).numpy()


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` (the default of
    every public entry point) or ``"cpu"``.  Asking for the card where
    none is present raises; nothing falls back to the host quietly."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is"
            " False; pass device='cpu' to run on the host")
    return dev


def _pow2(x: int) -> int:
    """Next power of two (>=1): quantizes pad shapes so nearby batch
    sizes share operand shapes."""
    return 1 << max(0, int(x) - 1).bit_length()


# ---------------------------------------------------------------------------
# Stage layouts: jagged groups -> fixed-shape padded matrices
# ---------------------------------------------------------------------------

# One stage's grouping of a batch: ``order`` permutes messages into
# group-major layout, ``counts``/``offsets`` delimit the groups, ``uniq``
# names each group's resource id (bank / rank / directed link).
RawLayout = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]

_LAYOUT_MEMO = _fb.CappedMemo(64)


def layout_memo_stats() -> dict:
    """Hit/miss counters of the stage-layout memo (shared by the torch
    and cuda engines)."""
    return _LAYOUT_MEMO.stats()


def clear_layout_memo() -> None:
    """Reset the torch engine's layout caches (stage layouts and stacked
    bucket operands) with their counters."""
    _LAYOUT_MEMO.clear()
    _BUCKET_MEMO.clear()


def _raw_layouts(src: np.ndarray, dst: np.ndarray, vci: np.ndarray,
                 n_vcis: int, n_ranks: int,
                 key: Optional[Hashable]) -> Tuple[RawLayout, ...]:
    """Group the batch by each stage's resource id (memoized by ``key``).

    The layouts depend only on the (src, dst, vci) columns — which the
    memo key fully determines — never on times or sizes.
    """
    lays = _LAYOUT_MEMO.get(key)
    if lays is None:
        lays = (_group_layout(src * n_vcis + vci),
                _group_layout(src),
                _group_layout(src * n_ranks + dst))
        _LAYOUT_MEMO.put(key, lays)
    return lays


def _pad_layout(lay: RawLayout, n: int, sentinel: int,
                G: Optional[int] = None, K: Optional[int] = None):
    """Pad one stage's jagged groups to a fixed ``(K, G)`` matrix.

    The layout is *step-major* — row k holds the k-th message of every
    group.  Returns ``(gather, mask, pos)``: ``gather[k, g]`` is the
    message id of the k-th message of group g (``sentinel`` — the shared
    dummy row — on padded slots), ``mask`` marks real slots, and
    ``pos[i]`` is the flattened padded position of message i, used to
    read per-message results back out of the scan output.
    """
    order, uniq, counts, offsets = lay
    Gi = len(counts)
    G = Gi if G is None else G
    K = (int(counts.max()) if Gi else 0) if K is None else K
    row = np.repeat(np.arange(Gi, dtype=np.int64), counts)
    col = np.arange(n, dtype=np.int64) - np.repeat(offsets, counts)
    gather = np.full((K, G), sentinel, dtype=np.int64)
    gather[col, row] = order
    mask = np.zeros((K, G), dtype=bool)
    mask[col, row] = True
    pos = np.empty(n, dtype=np.int64)
    pos[order] = col * G + row
    return gather, mask, pos


def _consts(cfg: NetConfig) -> Tuple[np.float64, ...]:
    """NetConfig costs as a float64 vector, in the order the fused
    kernel's cost vector uses: ``[2]`` is ``alpha_wire``, ``[6]``
    ``alpha_nic`` and ``[9]`` ``alpha_recv``."""
    return tuple(np.float64(v) for v in (
        cfg.beta, cfg.beta_copy, cfg.alpha_wire, cfg.alpha_first,
        cfg.alpha_msg, cfg.chi_switch, cfg.alpha_nic, cfg.alpha_put,
        cfg.alpha_put_first, cfg.alpha_recv, cfg.eager_max, cfg.bcopy_max))


def _host_costs(nbytes: np.ndarray, am_copy: np.ndarray, cfg: NetConfig
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-message protocol costs in host float64 — ``(copy_cost,
    wire_svc, rdv)``: the bcopy/AM copy cost added to the injection, the
    wire's bandwidth service time, and the rendezvous round trip added
    after the NIC stage (0.0 where a message pays none: adding 0.0 is
    bitwise identity for these positive times)."""
    nb = np.asarray(nbytes, dtype=np.float64)
    am = np.asarray(am_copy, dtype=bool)
    copy = am | ((nb > cfg.eager_max) & (nb <= cfg.bcopy_max))
    copy_cost = np.where(copy, nb / cfg.beta_copy, 0.0)
    rdv = np.where(~am & (nb > cfg.bcopy_max), 2.0 * cfg.alpha_wire, 0.0)
    return copy_cost, nb / cfg.beta, rdv


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

@dataclass
class _Operands:
    """One pipeline call's operands, batched on a leading axis of P
    items.  Message columns carry one trailing dummy row (the gather
    target of padded slots); per-item costs are ``(P, 1)`` columns."""
    t_ready: torch.Tensor    # (P, n_pad + 1) float (the mode's dtype)
    copy_cost: torch.Tensor  # (P, n_pad + 1) float
    wire_svc: torch.Tensor   # (P, n_pad + 1) float
    rdv: torch.Tensor        # (P, n_pad) float
    thread: torch.Tensor     # (P, n_pad + 1) int64
    put: torch.Tensor        # (P, n_pad + 1) bool
    stages: Tuple[tuple, ...]  # per stage (gather, mask, pos): (P, K, G)
    init: Tuple[torch.Tensor, ...]  # per stage busy-until (P, G) float
    prev1: torch.Tensor      # (P, G1) int64 last VCI owner (-1 = idle)
    costs: Dict[str, torch.Tensor]  # (P, 1) float per cost constant


_COST_NAMES = ("alpha_wire", "alpha_first", "alpha_msg", "chi_switch",
               "alpha_nic", "alpha_put", "alpha_put_first", "alpha_recv")


def _pipeline(ops: _Operands):
    """Advance a padded batch through VCI -> NIC -> wire.

    Performs exactly the scalar engine's IEEE-754 operations in the same
    per-resource order: each stage walks its depth axis in a Python
    loop, vectorized across groups and batch items.  Returns
    ``(arrivals (P, n_pad), cur1, prev1, cur2, cur3)``.
    """
    c = ops.costs
    P = ops.t_ready.shape[0]

    def gathered(col, g):
        return col.gather(1, g.reshape(P, -1)).view(g.shape)

    # Stage 1 — VCI banks: injection cost depends on the bank's previous
    # owner, so the scan carries (busy-until, last-thread).
    g1, m1, pos1 = ops.stages[0]
    r1, th1 = gathered(ops.t_ready, g1), gathered(ops.thread, g1)
    pt1, cc1 = gathered(ops.put, g1), gathered(ops.copy_cost, g1)
    cur, prev = ops.init[0].clone(), ops.prev1.clone()
    ys1 = torch.empty_like(r1)
    for k in range(r1.shape[1]):
        tk, pk, mk = th1[:, k], pt1[:, k], m1[:, k]
        base = torch.where(
            prev < 0,
            torch.where(pk, c["alpha_put_first"], c["alpha_first"]),
            torch.where(prev != tk, c["chi_switch"],
                        torch.where(pk, c["alpha_put"], c["alpha_msg"])))
        # adding 0.0 to non-copy rows is bitwise identity (as in the
        # NumPy engine's `cost + copy_cost`)
        t = torch.maximum(r1[:, k], cur) + (base + cc1[:, k])
        ys1[:, k] = t
        cur = torch.where(mk, t, cur)
        prev = torch.where(mk, tk, prev)
    cur1, prev1 = cur, prev
    zero = ops.t_ready.new_zeros((P, 1))
    t1 = torch.cat([ys1.reshape(P, -1).gather(1, pos1), zero], dim=1)

    # Stage 2 — per-rank NIC: constant service, then the rendezvous
    # RTS/CTS round trip for large non-AM messages (added after the
    # busy-until state, as in the scalar engine).
    g2, m2, pos2 = ops.stages[1]
    r2 = gathered(t1, g2)
    cur = ops.init[1].clone()
    ys2 = torch.empty_like(r2)
    for k in range(r2.shape[1]):
        t = torch.maximum(r2[:, k], cur) + c["alpha_nic"]
        ys2[:, k] = t
        cur = torch.where(m2[:, k], t, cur)
    cur2 = cur
    t2 = ys2.reshape(P, -1).gather(1, pos2) + ops.rdv
    t2 = torch.cat([t2, zero], dim=1)

    # Stage 3 — per-directed-link wires: bandwidth service time.
    g3, m3, pos3 = ops.stages[2]
    r3, s3 = gathered(t2, g3), gathered(ops.wire_svc, g3)
    cur = ops.init[2].clone()
    ys3 = torch.empty_like(r3)
    for k in range(r3.shape[1]):
        t = torch.maximum(r3[:, k], cur) + s3[:, k]
        ys3[:, k] = t
        cur = torch.where(m3[:, k], t, cur)
    t3 = ys3.reshape(P, -1).gather(1, pos3)
    return (t3 + c["alpha_wire"]) + c["alpha_recv"], cur1, prev1, cur2, cur


def _pad_cols(t_ready, nbytes, thread, put, am_copy, cfg: NetConfig,
              n_pad: int):
    """Host message columns padded to ``n_pad`` (plus one trailing dummy
    row where the pipeline gathers): ``t_ready, copy_cost, wire_svc,
    thread, put`` and the ``(n_pad,)`` rendezvous column."""
    copy_cost, wire_svc, rdv = _host_costs(nbytes, am_copy, cfg)

    def pad(a, fill, dtype, extra=1):
        out = np.full(n_pad + extra, fill, dtype=dtype)
        out[:a.shape[0]] = a
        return out
    return (pad(np.asarray(t_ready), 0.0, np.float64),
            pad(copy_cost, 0.0, np.float64),
            pad(wire_svc, 0.0, np.float64),
            pad(np.asarray(thread), 0, np.int64),
            pad(np.asarray(put), False, bool),
            pad(rdv, 0.0, np.float64, extra=0))


def _pad_pos(pos: np.ndarray, n_pad: int) -> np.ndarray:
    out = np.zeros(n_pad, dtype=np.int64)
    out[:pos.shape[0]] = pos
    return out


def _cost_table(cfgs: List[NetConfig], device) -> Dict[str, torch.Tensor]:
    return {name: upload(np.array([[getattr(cfg, name)] for cfg in cfgs],
                                  dtype=np.float64), device)
            for name in _COST_NAMES}


class TorchFabric(Fabric):
    """Torch fabric: the :class:`~repro_torch.core.fabric.Fabric`
    resource model with the staged scans as torch tensor steps on
    ``device``.

    Scalar state stays authoritative on the Python side exactly as in
    the NumPy engine, so warm-state semantics (steady-state iterations,
    dependent RMA traffic interleaved with batches) are identical; a
    staged batch converts the touched resources' state to tensors, runs
    one pipeline call, and writes the final clocks back.  Routing
    follows the same adaptive heuristics as the NumPy engine — tiny or
    narrow batches take the bit-identical scalar path.
    """

    def __init__(self, cfg: NetConfig, n_vcis: int, n_ranks: int = 2,
                 device="cuda"):
        super().__init__(cfg, n_vcis, n_ranks=n_ranks)
        self.device = resolve_device(device)

    def _narrow(self, n: int, per_src: np.ndarray) -> bool:
        """The adaptive cutoffs: too few or too deep for staged scans."""
        return (n <= _fb.SCALAR_BATCH_CUTOFF
                or n < _fb.MIN_GROUP_PARALLELISM * int(per_src.max()))

    def _count_sent(self, n: int, per_src: np.ndarray) -> None:
        self.n_messages += n
        for r, c in enumerate(per_src.tolist()):
            if c:
                self.sent_per_rank[r] += c

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
        n_pad = _pow2(n)
        pads = [_pad_layout(lay, n, n_pad, G=_pow2(len(lay[2])),
                            K=_pow2(int(lay[2].max()))) for lay in lays]

        # warm state in, padded to the quantized group counts
        banks = [(g // self.n_vcis, g % self.n_vcis)
                 for g in lays[0][1].tolist()]
        cur1 = np.zeros(pads[0][0].shape[1])
        cur1[:len(banks)] = [self.vci_free[r][v] for r, v in banks]
        prev1 = np.full(pads[0][0].shape[1], -1, dtype=np.int64)
        prev1[:len(banks)] = [-1 if self.vci_last_thread[r][v] is None
                              else self.vci_last_thread[r][v]
                              for r, v in banks]
        ranks = lays[1][1].tolist()
        cur2 = np.zeros(pads[1][0].shape[1])
        cur2[:len(ranks)] = [self.nic_free[r] for r in ranks]
        links = [(c // self.n_ranks, c % self.n_ranks)
                 for c in lays[2][1].tolist()]
        cur3 = np.zeros(pads[2][0].shape[1])
        cur3[:len(links)] = [self.wire_free.get(sd, 0.0) for sd in links]

        dev = self.device

        def t(a):  # one host array -> a (1, ...) device tensor
            return upload(a, dev)[None]
        tr, cc, ws, th, pt, rdv = _pad_cols(t_ready, nbytes, thread, put,
                                            am_copy, self.cfg, n_pad)
        ops = _Operands(
            t_ready=t(tr), copy_cost=t(cc), wire_svc=t(ws), rdv=t(rdv),
            thread=t(th), put=t(pt),
            stages=tuple((t(g), t(m), t(_pad_pos(pos, n_pad)))
                         for g, m, pos in pads),
            init=(t(cur1), t(cur2), t(cur3)), prev1=t(prev1),
            costs=_cost_table([self.cfg], dev))
        arr, c1, p1, c2, c3 = (host64(x[0]) for x in _pipeline(ops))

        # warm state out
        for (r, v), busy, owner in zip(banks, c1.tolist(), p1.tolist()):
            self.vci_free[r][v] = busy
            self.vci_last_thread[r][v] = int(owner) if owner >= 0 else None
        for r, busy in zip(ranks, c2.tolist()):
            self.nic_free[r] = busy
        self.wire_free.update(zip(links, c3.tolist()))
        self._count_sent(n, per_src)
        return arr[:n]


# ---------------------------------------------------------------------------
# The batched grid path
# ---------------------------------------------------------------------------

@dataclass
class GridItem:
    """One cold-start exchange of a whole-grid evaluation.

    Columns are already in global merge order (the caller's stable sort
    by ``t_ready``); ``key`` memoizes the stage layouts.
    """
    t_ready: np.ndarray
    nbytes: np.ndarray
    vci: np.ndarray
    thread: np.ndarray
    put: np.ndarray
    am_copy: np.ndarray
    src: np.ndarray
    dst: np.ndarray
    cfg: NetConfig
    n_vcis: int
    n_ranks: int
    key: Optional[Hashable] = None

    def __len__(self) -> int:
        return self.t_ready.shape[0]


def transmit_grid(items: List[GridItem], device="cuda") -> List[np.ndarray]:
    """Evaluate many independent cold-start exchanges, one batched
    pipeline call per ``(n_ranks, n_vcis)`` bucket.

    Items of a bucket are padded to the bucket's power-of-two maxima and
    stacked on the batch axis (the approach/theta/size axes of a sweep
    ride it).  Returns each item's per-message arrival times in its
    input (merge) order.
    """
    dev = resolve_device(device)
    out: List[Optional[np.ndarray]] = [None] * len(items)
    buckets: Dict[tuple, List[int]] = {}
    for i, it in enumerate(items):
        buckets.setdefault((it.n_ranks, it.n_vcis), []).append(i)
    for members in buckets.values():
        ops = _bucket_operands([items[i] for i in members], dev)
        arrivals = host64(_pipeline(ops)[0])
        for p, i in enumerate(members):
            out[i] = arrivals[p, :len(items[i])]
    return out  # type: ignore[return-value]


# Stacked padded operands of a whole bucket, keyed by the device, the
# precision mode and the members' layout keys: a repeated grid evaluation re-runs the
# pipeline on the resident tensors without re-padding anything.
_BUCKET_MEMO = _fb.CappedMemo(8)


def _stack_bucket(items: List[GridItem], device) -> _Operands:
    """Pad and stack one bucket's items into the pipeline's operands."""
    lays = [_raw_layouts(it.src, it.dst, it.vci % it.n_vcis, it.n_vcis,
                         it.n_ranks, it.key) for it in items]
    n_pad = _pow2(max(len(it) for it in items))
    dims = []  # per-stage (G, K) bucket maxima, quantized
    for s in range(3):
        G = _pow2(max(len(l[s][2]) for l in lays))
        K = _pow2(max(int(l[s][2].max()) for l in lays))
        dims.append((G, K))
    P = len(items)
    cols = [np.zeros((P, n_pad + 1), dtype=d) for d in
            (np.float64, np.float64, np.float64, np.int64, bool)]
    rdv = np.zeros((P, n_pad))
    stage = [(np.full((P, K, G), n_pad, dtype=np.int64),
              np.zeros((P, K, G), dtype=bool),
              np.zeros((P, n_pad), dtype=np.int64)) for G, K in dims]
    for p, (it, lay) in enumerate(zip(items, lays)):
        n = len(it)
        *padded, rdv_p = _pad_cols(it.t_ready, it.nbytes, it.thread,
                                   it.put, it.am_copy, it.cfg, n)
        for c, col in zip(cols, padded):
            c[p, :n] = col[:n]
        rdv[p, :n] = rdv_p
        for s, (G, K) in enumerate(dims):
            g, m, pos = _pad_layout(lay[s], n, n_pad, G=G, K=K)
            stage[s][0][p] = g
            stage[s][1][p] = m
            stage[s][2][p, :n] = pos

    def t(a):
        return upload(a, device)
    return _Operands(
        t_ready=t(cols[0]), copy_cost=t(cols[1]), wire_svc=t(cols[2]),
        rdv=t(rdv), thread=t(cols[3]), put=t(cols[4]),
        stages=tuple((t(g), t(m), t(pos)) for g, m, pos in stage),
        init=tuple(torch.zeros((P, G), dtype=float_dtype(), device=device)
                   for G, _ in dims),
        prev1=torch.full((P, dims[0][0]), -1, dtype=torch.int64,
                         device=device),
        costs=_cost_table([it.cfg for it in items], device))


def _bucket_operands(items: List[GridItem], device) -> _Operands:
    """Stack (or reuse) one bucket's device-resident operands."""
    key = None
    if all(it.key is not None for it in items):
        key = ("torch-grid", str(device), compat.x64_enabled(),
               tuple(it.key for it in items))
    ops = _BUCKET_MEMO.get(key)
    if ops is None:
        ops = _stack_bucket(items, device)
        _BUCKET_MEMO.put(key, ops)
    return ops
