"""The simulated network fabric: cost model, scalar oracle, batched engine.

The discrete-event model of the MPICH/UCX/IB stack is a three-stage
pipeline of serial resources:

  1. per-rank **VCI banks** — injection servers that remember their last
     owning thread (same-thread streaks pipeline at ``alpha_msg``; a
     thread switch pays the lock bounce ``chi_switch``),
  2. a per-rank **NIC** serialization stage (``alpha_nic`` per message,
     plus the rendezvous RTS/CTS round trip above ``bcopy_max``),
  3. per-directed-link **wires** (shared bandwidth ``beta`` + one-way
     latency ``alpha_wire``).

Two interchangeable engines implement that model:

  * :class:`ReferenceFabric` — the original scalar engine: one Python
    :meth:`~ReferenceFabric.transmit` call per wire message.  Kept as
    the differential-testing oracle (``engine="reference"``).
  * :class:`Fabric` — the batched engine: a whole traffic batch
    (:class:`IntentBatch` columns + per-message ``src``/``dst``) is
    advanced stage by stage with **grouped jagged scans**.  Each stage's
    state lives on independent resources (a (rank, vci) pair, a rank's
    NIC, a directed link), so the k-th message of *every* resource can
    be advanced simultaneously: the Python-level loop shrinks from
    ``n_messages`` iterations to ``max messages per resource``, with one
    NumPy op batch per step.  A 512-rank stencil (3072 flows, tens of
    thousands of messages) runs in a few dozen vector steps.

Both engines also expose a streaming entry point, ``advance``: one call
per *admission wave* of an open-loop workload, with all resource state
(warm VCIs, busy NICs and wires) carried between calls.

Bit-for-bit contract: the batched engine performs *the same IEEE-754
operations in the same order per resource* as the scalar engine — the
queue recurrence ``t[i] = max(ready[i], t[i-1]) + cost[i]`` is evaluated
sequentially along each resource's message subsequence (vectorized
*across* resources, never reassociated *within* one), so results match
the reference engine exactly, not merely within tolerance.

This is the PyTorch port's own copy of the JAX package's NumPy fabric:
both engines here are host NumPy and serve as the port's oracles for
the device engines in :mod:`repro_torch.core.fabric_torch` and
:mod:`repro_torch.core.fabric_cuda`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

US = 1e-6

# Batches at or below this size run through the scalar per-message path:
# a handful of messages is cheaper to advance with Python floats than
# with NumPy dispatch overhead.  Both paths compute identical values.
SCALAR_BATCH_CUTOFF = 8

# The staged scans advance one message per resource per step, so their
# Python-level step count is the *deepest* per-rank NIC chain; a batch
# only pays off when it is substantially wider than deep (one NumPy step
# costs roughly a dozen scalar transmits).  Narrow batches — single
# flows (one sender: depth == width), few-rank grids with many
# partitions per rank — fall back to the scalar path, which is faster
# and bit-identical.
MIN_GROUP_PARALLELISM = 16


@dataclass(frozen=True)
class NetConfig:
    """Cost constants of the simulated MPICH/UCX stack."""
    beta: float = 25e9            # wire bandwidth, B/s (200 Gb/s HDR)
    beta_copy: float = 12e9       # host memcpy bandwidth (bcopy / AM copy)
    alpha_wire: float = 0.80 * US  # one-way wire latency
    alpha_first: float = 0.30 * US  # injection cost, idle VCI
    alpha_msg: float = 0.10 * US  # marginal injection, same thread streak
    chi_switch: float = 2.60 * US  # injection when the VCI's previous
    #                                message came from another thread
    alpha_nic: float = 0.03 * US  # per-message NIC serialization
    alpha_put: float = 0.08 * US  # marginal injection for RMA put
    alpha_put_first: float = 0.25 * US
    alpha_atomic: float = 0.02 * US  # MPI_Pready atomic decrement (local)
    alpha_bounce: float = 0.04 * US  # cache-line bounce on the shared
    #                                  counter when several threads Pready
    alpha_counter: float = 0.10 * US  # shared partitioned-request state
    alpha_progress: float = 0.20 * US  # progress-engine cost per extra window
    alpha_recv: float = 0.05 * US  # receiver-side completion processing
    barrier_base: float = 0.05 * US
    barrier_log: float = 0.15 * US
    alpha_init: float = 25.0 * US  # one-time persistent-request / window
    #                                setup (MPI_Psend_init, MPI_Win_create)
    alpha_init_msg: float = 0.50 * US  # per planned wire message at init
    eager_max: int = 1024         # short protocol  <= 1 KiB
    bcopy_max: int = 8192         # bcopy protocol  <= 8 KiB, then rendezvous

    def barrier(self, n_threads: int) -> float:
        if n_threads <= 1:
            return 0.0
        return self.barrier_base + self.barrier_log * math.log2(n_threads)


DEFAULT_NET = NetConfig()


@dataclass
class IntentBatch:
    """A schedule's planned traffic as structured columns.

    One row per wire message, in the schedule's canonical injection
    order.  ``src``/``dst`` are *not* columns: a batch describes one
    flow's traffic independent of its endpoints, so multi-flow scenarios
    can build the batch once per equivalence class and re-stamp it per
    (src, dst) pair.
    """
    t_ready: np.ndarray   # float64: earliest injection time
    nbytes: np.ndarray    # float64: payload size
    vci: np.ndarray       # int64: target VCI (pre-modulo)
    thread: np.ndarray    # int64: issuing thread
    put: np.ndarray       # bool: RMA put injection costs
    am_copy: np.ndarray   # bool: old-AM full-buffer copy path

    def __len__(self) -> int:
        return self.t_ready.shape[0]

    @staticmethod
    def from_intents(intents) -> "IntentBatch":
        """Columnize any iterable of Intent-shaped objects."""
        ints = list(intents)
        return IntentBatch(
            t_ready=np.array([i.t_ready for i in ints], dtype=np.float64),
            nbytes=np.array([i.nbytes for i in ints], dtype=np.float64),
            vci=np.array([i.vci for i in ints], dtype=np.int64),
            thread=np.array([i.thread for i in ints], dtype=np.int64),
            put=np.array([i.put for i in ints], dtype=bool),
            am_copy=np.array([i.am_copy for i in ints], dtype=bool),
        )


class ReferenceFabric:
    """Scalar oracle: per-rank V VCIs -> per-rank NIC -> per-link wire.

    The default two-rank fabric with flow (0 -> 1) reproduces the paper's
    Fig-3 sender/receiver pair; halo scenarios instantiate R ranks and run
    bidirectional flows over distinct (src, dst) links.  State persists
    across iterations: warm VCIs remember their last owner, so a thread
    re-using its own VCI pays only the marginal injection, while a VCI
    last driven by another thread pays the lock bounce — which can make
    warm iterations *dearer* than the one-shot benchmark's all-idle VCIs
    (``alpha_first``) for schedules that rotate threads over VCIs.
    """

    def __init__(self, cfg: NetConfig, n_vcis: int, n_ranks: int = 2):
        self.cfg = cfg
        self.n_vcis = max(1, n_vcis)
        self.n_ranks = max(2, n_ranks)
        self.vci_free = [[0.0] * self.n_vcis for _ in range(self.n_ranks)]
        self.vci_last_thread: List[List[Optional[int]]] = [
            [None] * self.n_vcis for _ in range(self.n_ranks)]
        self.nic_free = [0.0] * self.n_ranks
        self.wire_free: Dict[tuple, float] = {}
        self.n_messages = 0
        self.sent_per_rank = [0] * self.n_ranks  # wire messages injected

    def _inject_cost(self, rank: int, vci: int, thread: int,
                     put: bool) -> float:
        cfg = self.cfg
        last = self.vci_last_thread[rank][vci]
        if last is None:
            return cfg.alpha_put_first if put else cfg.alpha_first
        if last != thread:
            return cfg.chi_switch
        return cfg.alpha_put if put else cfg.alpha_msg

    def transmit(self, t_ready: float, nbytes: float, vci: int, thread: int,
                 *, put: bool = False, am_copy: bool = False,
                 src: int = 0, dst: int = 1) -> float:
        """Schedule one message src -> dst; returns receiver arrival time."""
        cfg = self.cfg
        vci %= self.n_vcis
        inject = self._inject_cost(src, vci, thread, put)
        if am_copy or (cfg.eager_max < nbytes <= cfg.bcopy_max):
            inject += nbytes / cfg.beta_copy  # bcopy / AM intermediate copy
        t0 = max(t_ready, self.vci_free[src][vci])
        t1 = t0 + inject
        self.vci_free[src][vci] = t1
        self.vci_last_thread[src][vci] = thread
        t2 = max(t1, self.nic_free[src]) + cfg.alpha_nic
        self.nic_free[src] = t2
        if not am_copy and nbytes > cfg.bcopy_max:
            t2 += 2.0 * cfg.alpha_wire  # rendezvous RTS/CTS round trip
        t3s = max(t2, self.wire_free.get((src, dst), 0.0))
        t3 = t3s + self._wire_service(t3s, nbytes, src, dst)
        self.wire_free[(src, dst)] = t3
        self.n_messages += 1
        self.sent_per_rank[src] += 1
        return t3 + cfg.alpha_wire + cfg.alpha_recv

    def _wire_service(self, t_start: float, nbytes: float, src: int,
                      dst: int) -> float:
        """Wire service time for one message whose transfer starts at
        ``t_start``.  The seam a fault-injection layer overrides (a
        degraded link's bandwidth inside a time window); the healthy
        fabric is pure bandwidth."""
        return nbytes / self.cfg.beta

    def advance(self, t_ready: np.ndarray, nbytes: np.ndarray,
                vci: np.ndarray, thread: np.ndarray,
                put: np.ndarray, am_copy: np.ndarray,
                src: np.ndarray, dst: np.ndarray, *,
                layout_key=None) -> np.ndarray:
        """Admit one *wave* of messages into the live fabric.

        The online entry point of the open-loop serving path: instead of
        requiring the whole traffic batch up front (``transmit_arrays``
        on the batched engines), a driver feeds traffic as it arrives —
        each call is one admission wave, rows already in the wave's
        processing order (stable-sorted by ``t_ready``, exactly like the
        closed-loop merge).  All resource state persists between calls,
        so a sequence of waves composes into one long run: the k-th wave
        sees VCIs/NICs/wires still busy from wave k-1.  The scalar
        engine processes a wave one :meth:`transmit` at a time; the
        batched engines override this with their staged paths —
        bit-for-bit identical by the engine contract.  ``layout_key``
        names the wave's layout class for engines that memoize stage
        layouts (the torch/cuda engines); it is ignored here.
        """
        return np.array([
            self.transmit(float(t_ready[i]), float(nbytes[i]),
                          int(vci[i]), int(thread[i]),
                          put=bool(put[i]), am_copy=bool(am_copy[i]),
                          src=int(src[i]), dst=int(dst[i]))
            for i in range(t_ready.shape[0])])


class CappedMemo:
    """Tiny process-level LRU memo shared by the engines' layout caches.

    A dict with a size cap and hit/miss/eviction counters: a hit
    refreshes the entry's recency, and an insert past the cap evicts the
    least-recently-used entry — never the whole cache, so a sweep that
    cycles through more layouts than the cap (32k-rank grids interleaved
    with small differential points) degrades to partial reuse instead of
    thrashing, and memory stays bounded by ``cap`` entries.  Every entry
    is a pure recomputable function of its key, so eviction is always
    safe.  A ``None`` key disables memoization for that call.
    """

    def __init__(self, cap: int):
        self.cap = cap
        self._d: dict = {}  # insertion-ordered; last = most recent
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key):
        if key is None:
            return None
        value = self._d.get(key)
        if value is None:
            self.misses += 1
        else:
            self.hits += 1
            # refresh recency: move to the ordered dict's tail
            del self._d[key]
            self._d[key] = value
        return value

    def put(self, key, value) -> None:
        if key is None:
            return
        if key in self._d:
            del self._d[key]
        elif len(self._d) >= self.cap:
            self._d.pop(next(iter(self._d)))  # LRU = ordered-dict head
            self.evictions += 1
        self._d[key] = value

    def clear(self) -> None:
        self._d.clear()
        self.hits = self.misses = self.evictions = 0

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "size": len(self._d),
                "cap": self.cap}

    def __len__(self) -> int:
        return len(self._d)


def _group_layout(gid: np.ndarray):
    """Group a batch by resource id, preserving in-group processing order.

    Returns ``(order, uniq, counts, offsets)``: a stable permutation into
    group-major layout, the distinct resource ids, and each group's length
    and start offset in the permuted arrays.
    """
    order = np.argsort(gid, kind="stable")
    sorted_gid = gid[order]
    uniq, counts = np.unique(sorted_gid, return_counts=True)
    offsets = np.zeros(len(uniq), dtype=np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    return order, uniq, counts, offsets


def _queue_scan(r: np.ndarray, service: np.ndarray, init_free: np.ndarray,
                counts: np.ndarray, offsets: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Grouped serial-queue recurrence ``t[i] = max(r[i], t[i-1]) + c[i]``.

    ``r``/``service`` are already in group-major layout; the recurrence is
    evaluated sequentially *within* each group (same op order as the
    scalar engine, so bit-for-bit) and vectorized *across* groups: step k
    advances the k-th message of every still-active group at once.
    Returns the per-message finish times (group-major) and each group's
    final busy-until time.
    """
    out = np.empty_like(r)
    cur = init_free.copy()
    for k in range(int(counts.max()) if len(counts) else 0):
        act = counts > k
        idx = offsets[act] + k
        t = np.maximum(r[idx], cur[act]) + service[idx]
        out[idx] = t
        cur[act] = t
    return out, cur


class Fabric(ReferenceFabric):
    """Batched fabric: the :class:`ReferenceFabric` resource model plus a
    whole-batch path (:meth:`transmit_arrays`) advancing one *stage* at a
    time with grouped scans.

    Scalar state (lists, the inherited per-message :meth:`transmit`) is
    kept authoritative and converted to arrays only around a staged
    batch, so dependent-traffic schedules (RMA epochs), tiny batches and
    grouped scans compose on one fabric with identical warm-state
    semantics — and single messages stay as cheap as the reference.
    Batches below :data:`SCALAR_BATCH_CUTOFF` messages, or narrower than
    :data:`MIN_GROUP_PARALLELISM` times their deepest per-rank chain,
    take the scalar path; both paths are bit-identical, the choice is
    purely a throughput heuristic.
    """

    def _transmit_scalar(self, t_ready, nbytes, vci, thread, put, am_copy,
                         src, dst) -> np.ndarray:
        # the reference engine's wave loop IS the scalar fallback
        return ReferenceFabric.advance(self, t_ready, nbytes, vci, thread,
                                       put, am_copy, src, dst)

    def advance(self, t_ready: np.ndarray, nbytes: np.ndarray,
                vci: np.ndarray, thread: np.ndarray,
                put: np.ndarray, am_copy: np.ndarray,
                src: np.ndarray, dst: np.ndarray, *,
                layout_key=None) -> np.ndarray:
        """Online wave admission on the batched engine.

        Same contract as :meth:`ReferenceFabric.advance` — state carries
        across waves — routed through :meth:`transmit_arrays`, so a wide
        wave takes the staged grouped scans and a narrow one falls back
        to the scalar path (bit-identical either way).  The torch/cuda
        engines inherit this and supply their own ``transmit_arrays``,
        giving all four engines one streaming entry point.
        """
        return self.transmit_arrays(t_ready, nbytes, vci, thread, put,
                                    am_copy, src, dst,
                                    layout_key=layout_key)

    def transmit_arrays(self, t_ready: np.ndarray, nbytes: np.ndarray,
                        vci: np.ndarray, thread: np.ndarray,
                        put: np.ndarray, am_copy: np.ndarray,
                        src: np.ndarray, dst: np.ndarray, *,
                        layout_key=None) -> np.ndarray:
        """Advance a whole traffic batch through the three stages.

        Rows must already be in global processing order (the caller merges
        flows by ``t_ready`` with a stable sort, exactly as the scalar
        ``_run_flows`` does).  Returns per-message receiver arrival times
        in the same row order.  ``layout_key`` is accepted for engine
        interchangeability (the torch engine memoizes its stage layouts
        under it); this engine recomputes groupings per call.
        """
        n = t_ready.shape[0]
        if n == 0:
            return np.empty(0)
        per_src = np.bincount(src, minlength=self.n_ranks)
        if n <= SCALAR_BATCH_CUTOFF \
                or n < MIN_GROUP_PARALLELISM * int(per_src.max()):
            return self._transmit_scalar(t_ready, nbytes, vci, thread,
                                         put, am_copy, src, dst)
        cfg = self.cfg
        vci = vci % self.n_vcis

        # Stage 1 — VCI banks: injection cost depends on the bank's
        # previous owner, so the scan carries (busy-until, last-thread).
        t1 = self._vci_stage(t_ready, nbytes, vci, thread, put, am_copy, src)

        # Stage 2 — per-rank NIC: constant service, then the rendezvous
        # RTS/CTS round trip for large non-AM messages (added *after* the
        # NIC busy-until state, as in the scalar engine).
        order, uniq, counts, offsets = _group_layout(src)
        nic_free = np.array([self.nic_free[r] for r in uniq.tolist()])
        service = np.full(n, cfg.alpha_nic)
        out, cur = _queue_scan(t1[order], service, nic_free, counts, offsets)
        for r, v in zip(uniq.tolist(), cur.tolist()):
            self.nic_free[r] = v
        t2 = np.empty(n)
        t2[order] = out
        rdv = ~am_copy & (nbytes > cfg.bcopy_max)
        t2[rdv] += 2.0 * cfg.alpha_wire

        # Stage 3 — per-directed-link wires: bandwidth service time.
        link = src * self.n_ranks + dst
        order, uniq, counts, offsets = _group_layout(link)
        links = [(c // self.n_ranks, c % self.n_ranks)
                 for c in uniq.tolist()]
        init = np.array([self.wire_free.get(sd, 0.0) for sd in links])
        out, cur = self._wire_scan(t2[order], nbytes[order], src[order],
                                   dst[order], init, counts, offsets)
        self.wire_free.update(zip(links, cur.tolist()))
        t3 = np.empty(n)
        t3[order] = out

        self.n_messages += n
        for r, c in enumerate(per_src.tolist()):
            if c:
                self.sent_per_rank[r] += c
        return t3 + cfg.alpha_wire + cfg.alpha_recv

    def _wire_scan(self, r: np.ndarray, nbytes_s: np.ndarray,
                   src_s: np.ndarray, dst_s: np.ndarray,
                   init: np.ndarray, counts: np.ndarray,
                   offsets: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Stage-3 grouped scan — the batched counterpart of
        :meth:`ReferenceFabric._wire_service`.  Inputs are link-major
        (``r``/``nbytes_s``/``src_s``/``dst_s`` already permuted); the
        healthy engine's service is pure bandwidth, so the whole service
        column precomputes and the generic scan applies.  The faulty
        engine overrides this with a time-dependent per-step factor."""
        return _queue_scan(r, nbytes_s / self.cfg.beta, init, counts,
                           offsets)

    def _vci_stage(self, t_ready, nbytes, vci, thread, put, am_copy, src):
        """Grouped scan over (src rank, vci) banks with owner tracking."""
        cfg = self.cfg
        gid = src * self.n_vcis + vci
        order, uniq, counts, offsets = _group_layout(gid)
        r_s = t_ready[order]
        th_s = thread[order]
        put_s = put[order]
        copy_s = (am_copy | ((nbytes > cfg.eager_max)
                             & (nbytes <= cfg.bcopy_max)))[order]
        copy_cost = np.where(copy_s, nbytes[order] / cfg.beta_copy, 0.0)
        banks = [(g // self.n_vcis, g % self.n_vcis) for g in uniq.tolist()]
        cur = np.array([self.vci_free[r][v] for r, v in banks])
        prev = np.array([-1 if self.vci_last_thread[r][v] is None
                         else self.vci_last_thread[r][v]
                         for r, v in banks], dtype=np.int64)
        out = np.empty_like(r_s)
        for k in range(int(counts.max())):
            act = counts > k
            idx = offsets[act] + k
            th, pt, pv = th_s[idx], put_s[idx], prev[act]
            cost = np.where(
                pv < 0,
                np.where(pt, cfg.alpha_put_first, cfg.alpha_first),
                np.where(pv != th, cfg.chi_switch,
                         np.where(pt, cfg.alpha_put, cfg.alpha_msg)))
            # adding 0.0 to the non-copy rows is bitwise identity for the
            # (positive) injection constants, so this matches the scalar
            # engine's conditional `inject += nbytes / beta_copy`
            cost = cost + copy_cost[idx]
            t = np.maximum(r_s[idx], cur[act]) + cost
            out[idx] = t
            cur[act] = t
            prev[act] = th
        for (r, v), busy, owner in zip(banks, cur.tolist(), prev.tolist()):
            self.vci_free[r][v] = busy
            self.vci_last_thread[r][v] = owner if owner >= 0 else None
        t1 = np.empty_like(out)
        t1[order] = out
        return t1
