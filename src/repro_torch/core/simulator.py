"""Discrete-event simulator of the paper's pipelined-communication
benchmark, on the PyTorch port's fabric engines.

The port's counterpart of the JAX package's ``core/simulator.py``:
:func:`simulate` (one flow of the Fig-3 benchmark, Figs 4-8),
:func:`simulate_steady_state` (a persistent request over iterations),
:func:`simulate_halo` (1-D halo exchange), :func:`simulate_stencil`
(N-D Cartesian stencil) and the whole-grid
:func:`simulate_stencil_grid`, :func:`simulate_imbalance` (a ring under
the Appendix-A compute noise), :func:`simulate_serving` (open-loop
request traces through the streaming ``advance`` path),
:func:`simulate_faulty` (a stencil under seeded drops and degraded
links) and :func:`simulate_membership` (ranks leaving and rejoining
mid-run).  The host arithmetic of every driver is the reference's,
operation for operation; only the fabric underneath differs.  A single
flow (:func:`simulate`, :func:`simulate_steady_state`) runs the scalar
path on every engine, and with active faults the device engines run on
the NumPy faulty fabric, as the reference's compiled engines do.

Each API variant is a :class:`Schedule` registered in ``SCHEDULES``;
schedules turn a partitioned, pt2pt or RMA exchange into wire-message
intents, one stable merge orders every flow's messages, and a fabric
(:mod:`repro_torch.core.fabric`) advances the per-rank VCI banks, NICs
and per-link wires.  Every driver takes an ``engine`` argument:

  * ``engine="cuda"`` (default) — the hand-written CUDA kernels of
    :mod:`repro_torch.core.fabric_cuda`;
  * ``engine="torch"`` — torch tensor scans
    (:mod:`repro_torch.core.fabric_torch`);
  * ``engine="vector"`` — the batched NumPy engine;
  * ``engine="reference"`` — the scalar oracle.

and a ``device`` argument, ``"cuda"`` unless the caller passes
``"cpu"``; asking for the card where none is present raises.  The four
engines agree bit-for-bit in float64.

Calibration targets (the paper's Figs 4-8):
  fig 4: single-message small latency ~1.2 us; part==single; old-AM worse.
  fig 5: 32 threads, 1 VCI  -> part/many ~30x single.
  fig 6: 32 threads, 32 VCI -> many ~= single; part ~3-4x single.
  fig 7: 4 threads, theta=32 -> no-aggr ~10x single; aggregated ~3x.
  fig 8: gamma=100 us/MB, N=4 -> measured gain ~2.5 (theory 2.67).
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from . import fabric_cuda, fabric_torch
from .arrivals import make_trace
from .fabric import (US, DEFAULT_NET, CappedMemo, Fabric, IntentBatch,
                     NetConfig, ReferenceFabric)
from .fabric_torch import resolve_device
from .faults import DropDraws, FaultSpec, make_faulty_fabric
from .partition import PartitionedRequest
from .recovery import make_policy
from .topology import CartTopology, HaloSpec

# The fabric engines selectable via the drivers' ``engine`` argument.
ENGINES = ("vector", "reference", "torch", "cuda")
# The engines of the whole-grid path.
GRID_ENGINES = ("torch", "cuda")


def _make_fabric(engine: str, cfg: NetConfig, n_vcis: int,
                 n_ranks: int = 2, device="cuda"):
    dev = resolve_device(device)
    if engine == "vector":
        return Fabric(cfg, n_vcis, n_ranks=n_ranks)
    if engine == "reference":
        return ReferenceFabric(cfg, n_vcis, n_ranks=n_ranks)
    if engine == "torch":
        return fabric_torch.TorchFabric(cfg, n_vcis, n_ranks=n_ranks,
                                        device=dev)
    if engine == "cuda":
        return fabric_cuda.CudaFabric(cfg, n_vcis, n_ranks=n_ranks,
                                      device=dev)
    raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")


@dataclass
class SimResult:
    time_s: float          # time-to-solution minus compute (paper's metric)
    tts_s: float           # absolute completion time on the receiver
    n_messages: int
    approach: str

    @property
    def time_us(self) -> float:
        return self.time_s / US


@dataclass
class Scenario:
    """One flow of the Fig-3 benchmark: ``n_threads`` producer threads on
    rank ``src``, theta partitions each, sending to rank ``dst``.

    ``ready[t, j]`` is the time partition j of thread t finishes compute,
    in seconds from this flow's epoch ``t0`` (MPI_Start).  The cached
    :meth:`request` is the persistent-request analogue: steady-state runs
    rebuild nothing between iterations, only ``t0`` advances.
    """
    n_threads: int
    theta: int
    part_bytes: float
    ready: np.ndarray
    n_vcis: int = 1
    aggr_bytes: float = 0.0
    cfg: NetConfig = DEFAULT_NET
    src: int = 0
    dst: int = 1
    t0: float = 0.0
    # Optional precomputed intent-memoization key: scenarios sharing it
    # must produce identical intent batches (same everything but
    # endpoints).  Drivers that know their equivalence classes (stencil:
    # one per dimension) set it to skip hashing the ready table per flow.
    class_key: Optional[tuple] = field(default=None, compare=False)
    _request: Optional[PartitionedRequest] = field(
        default=None, repr=False, compare=False)

    @property
    def n_part(self) -> int:
        return self.n_threads * self.theta

    @property
    def total_bytes(self) -> float:
        return self.n_part * self.part_bytes

    @property
    def start(self) -> float:
        """MPI_Start + thread barrier (Fig 3), from this flow's epoch."""
        return self.t0 + self.cfg.barrier(self.n_threads)

    @property
    def compute(self) -> float:
        return float(self.ready.max())

    def request(self) -> PartitionedRequest:
        """The flow's persistent partitioned request (built once)."""
        if self._request is None:
            self._request = PartitionedRequest(
                self.n_part, self.n_part, self.part_bytes,
                aggr_bytes=self.aggr_bytes,
                n_channels=max(1, self.n_vcis))
        return self._request


@dataclass(frozen=True)
class Intent:
    """One planned injection: what a schedule wants the fabric to send."""
    t_ready: float
    nbytes: float
    vci: int
    thread: int
    put: bool = False
    am_copy: bool = False


class Schedule:
    """One API variant of the paper's benchmark (its §2.3 taxonomy).

    Pipelinable variants describe their traffic as :class:`Intent` lists
    (``intents``), which lets multi-flow scenarios (halo exchange) merge
    several flows in global time order on one fabric; ``run`` then injects
    the canonical-order intents and applies ``finish``.  Variants whose
    traffic depends on earlier arrivals (RMA epochs: the flush/complete
    message waits for the puts) override ``run`` directly and return None
    from ``intents``.  ``n_requests`` is the number of persistent
    requests/windows set up once (steady-state init accounting).
    """

    name: str = ""

    def intents(self, sc: Scenario) -> Optional[List[Intent]]:
        return None

    def intent_batch(self, sc: Scenario) -> Optional[IntentBatch]:
        """The flow's traffic as structured arrays (vectorized engine).

        Defaults to columnizing :meth:`intents`; schedules whose plan is
        itself array-shaped override this to skip the per-partition
        Python loop entirely.  Returns None for dependent-traffic
        schedules, which then run message-by-message via :meth:`run`.
        """
        ints = self.intents(sc)
        if ints is None:
            return None
        return IntentBatch.from_intents(ints)

    def finish(self, sc: Scenario, fab,
               arrivals) -> float:
        """Post-traffic completion processing (e.g. barrier before Wait)."""
        if isinstance(arrivals, np.ndarray):
            return float(arrivals.max())
        return max(arrivals)

    def finish_batch(self, flows: Sequence[Scenario], fab,
                     flow_max: np.ndarray) -> Optional[np.ndarray]:
        """Vectorized :meth:`finish` over merged flows, or None.

        ``flow_max[i]`` is the max arrival of flow i's messages.  The
        default covers every schedule that doesn't override ``finish``;
        a schedule with a custom ``finish`` either overrides this
        consistently or returns None to fall back to per-flow calls.
        Implementations must be pure and uniformly return None or an
        array regardless of the flow count (the class-based fast path
        probes with an empty flow list).
        """
        if type(self).finish is Schedule.finish:
            return flow_max
        return None

    def run(self, sc: Scenario, fab) -> float:
        ints = self.intents(sc)
        if ints is None:
            raise NotImplementedError(f"{self.name} must override run()")
        arrivals = [fab.transmit(i.t_ready, i.nbytes, vci=i.vci,
                                 thread=i.thread, put=i.put,
                                 am_copy=i.am_copy, src=sc.src, dst=sc.dst)
                    for i in ints]
        return self.finish(sc, fab, arrivals)

    def n_requests(self, sc: Scenario) -> int:
        return 1


SCHEDULES: Dict[str, Schedule] = {}


def register_schedule(schedule: Schedule) -> Schedule:
    """Add a schedule instance to the registry (last registration wins)."""
    if not schedule.name:
        raise ValueError("schedule must define a name")
    SCHEDULES[schedule.name] = schedule
    return schedule


class PartitionedSchedule(Schedule):
    """Improved MPI-4.0 partitioned path (§3.2): gcd message plan,
    aggregation under aggr_bytes, round-robin message->VCI mapping,
    per-Pready atomic + shared-request serialization per message."""

    name = "part"

    def intents(self, sc: Scenario) -> List[Intent]:
        cfg, start = sc.cfg, sc.start
        req = sc.request()
        pready = np.empty(sc.n_part)
        bounce_free = 0.0  # globally-serialized atomic counter cache line
        for t in range(sc.n_threads):
            t_free = start
            for j in range(sc.theta):
                t_done = max(t_free, start + sc.ready[t, j]) + cfg.alpha_atomic
                if sc.n_threads > 1:
                    t_done = max(t_done, bounce_free) + cfg.alpha_bounce
                    bounce_free = t_done
                pready[t * sc.theta + j] = t_done
                t_free = t_done
        counter_free = 0.0  # shared partitioned-request state (serializing)
        out = []
        for msg in req.messages:
            t_ready = max(pready[p] for p in msg.partitions)
            if sc.n_threads > 1:
                t_ready = max(t_ready, counter_free) + cfg.alpha_counter
                counter_free = t_ready
            owner = msg.partitions[-1] // sc.theta
            out.append(Intent(t_ready, msg.nbytes, vci=msg.channel,
                              thread=owner))
        return out

    def finish(self, sc: Scenario, fab, arrivals) -> float:
        # barrier before MPI_Wait
        if isinstance(arrivals, np.ndarray):
            return float(arrivals.max()) + sc.cfg.barrier(sc.n_threads)
        return max(arrivals) + sc.cfg.barrier(sc.n_threads)

    def finish_batch(self, flows: Sequence[Scenario], fab,
                     flow_max: np.ndarray) -> np.ndarray:
        barriers: Dict[tuple, float] = {}
        barr = np.empty(len(flows))
        for i, sc in enumerate(flows):
            key = (id(sc.cfg), sc.n_threads)
            b = barriers.get(key)
            if b is None:  # lazily: setdefault would re-derive the
                b = barriers[key] = sc.cfg.barrier(sc.n_threads)  # log2
            barr[i] = b    # per flow even on memo hits
        return flow_max + barr

    def n_requests(self, sc: Scenario) -> int:
        return sc.request().n_messages


class OldPartitionedSchedule(Schedule):
    """Original AM path (§3.1): wait for CTS, copy the whole buffer,
    single active message once every partition is ready."""

    name = "part_old"

    def intents(self, sc: Scenario) -> List[Intent]:
        cfg = sc.cfg
        t0 = (sc.start + sc.compute + cfg.barrier(sc.n_threads)
              + cfg.alpha_wire)
        return [Intent(t0, sc.total_bytes, vci=0, thread=0, am_copy=True)]


class Pt2PtSingleSchedule(Schedule):
    """Bulk synchronization: barrier until every thread is done, then one
    persistent send from the master thread."""

    name = "pt2pt_single"

    def intents(self, sc: Scenario) -> List[Intent]:
        t0 = sc.start + sc.compute + sc.cfg.barrier(sc.n_threads)
        return [Intent(t0, sc.total_bytes, vci=0, thread=0)]


class Pt2PtManySchedule(Schedule):
    """One duplicated communicator per thread, one persistent request per
    partition, issued as soon as each partition is ready."""

    name = "pt2pt_many"

    def intents(self, sc: Scenario) -> List[Intent]:
        start = sc.start
        out = []
        for t in range(sc.n_threads):
            t_free = start
            for j in range(sc.theta):
                t_issue = max(t_free, start + sc.ready[t, j])
                out.append(Intent(t_issue, sc.part_bytes,
                                  vci=t % max(1, sc.n_vcis), thread=t))
                t_free = t_issue  # issue cost accounted inside the VCI queue
        return out

    def intent_batch(self, sc: Scenario) -> IntentBatch:
        # The per-thread issue chain is a running max along theta (the
        # issue cost is accounted inside the VCI queue), so the whole
        # plan builds as one cummax — max is associative, so folding the
        # ``start`` seed in afterwards is bit-identical to the loop.
        start = sc.start
        issue = np.maximum(
            np.maximum.accumulate(start + sc.ready, axis=1), start)
        n = sc.n_part
        threads = np.arange(sc.n_threads, dtype=np.int64)
        return IntentBatch(
            t_ready=issue.ravel(),
            nbytes=np.full(n, float(sc.part_bytes)),
            vci=np.repeat(threads % max(1, sc.n_vcis), sc.theta),
            thread=np.repeat(threads, sc.theta),
            put=np.zeros(n, dtype=bool),
            am_copy=np.zeros(n, dtype=bool))

    def n_requests(self, sc: Scenario) -> int:
        return sc.n_part


class RmaSchedule(Schedule):
    """RMA put variants: single/many windows x passive/active target."""

    def __init__(self, many: bool, active: bool):
        self.many = many
        self.active = active
        self.name = (f"rma_{'many' if many else 'single'}"
                     f"_{'active' if active else 'passive'}")

    def run(self, sc: Scenario, fab: ReferenceFabric) -> float:
        cfg, start = sc.cfg, sc.start
        arrivals = []
        flush_done = start
        for t in range(sc.n_threads):
            vci = (t % max(1, sc.n_vcis)) if self.many else 0
            t_free = start
            if self.active:
                # MPI_Start on the origin waits for the target's MPI_Post
                # exposure message (0B) — steady state: one wire latency.
                t_free += cfg.alpha_wire
            for j in range(sc.theta):
                t_issue = max(t_free, start + sc.ready[t, j])
                arr = fab.transmit(t_issue, sc.part_bytes, vci=vci, thread=t,
                                   put=True, src=sc.src, dst=sc.dst)
                t_free = t_issue
                arrivals.append(arr)
            last = max(arrivals[-sc.theta:])
            if self.active:
                # MPI_Complete: 0B sync message closing the access epoch.
                done = fab.transmit(last, 0.0, vci=vci, thread=t,
                                    src=sc.src, dst=sc.dst)
            else:
                # MPI_Win_flush round trip + 0B completion send.
                done = fab.transmit(last + 2.0 * cfg.alpha_wire, 0.0,
                                    vci=vci, thread=t,
                                    src=sc.src, dst=sc.dst)
            flush_done = max(flush_done, done)
        tts = flush_done
        if self.many:
            # Receiver progress engine polls one window per thread (§4.2.1).
            tts += cfg.alpha_progress * sc.n_threads
        return tts + cfg.barrier(sc.n_threads)

    def n_requests(self, sc: Scenario) -> int:
        return sc.n_threads if self.many else 1


register_schedule(PartitionedSchedule())
register_schedule(OldPartitionedSchedule())
register_schedule(Pt2PtSingleSchedule())
register_schedule(Pt2PtManySchedule())
register_schedule(RmaSchedule(many=False, active=False))
register_schedule(RmaSchedule(many=True, active=False))
register_schedule(RmaSchedule(many=False, active=True))
register_schedule(RmaSchedule(many=True, active=True))

APPROACHES = tuple(SCHEDULES)


def _lookup(approach: str) -> Schedule:
    sched = SCHEDULES.get(approach)
    if sched is None:
        raise ValueError(f"unknown approach {approach!r}; one of {APPROACHES}")
    return sched


def _normalize_ready(n_threads: int, theta: int,
                     ready: Optional[Sequence]) -> np.ndarray:
    if ready is None:
        return np.zeros((n_threads, theta))
    arr = np.asarray(ready, dtype=float)
    if arr.size != n_threads * theta:
        raise ValueError(
            f"ready table has shape {arr.shape} ({arr.size} entries);"
            f" expected (n_threads, theta) = ({n_threads}, {theta})"
            f" [{n_threads * theta} entries]")
    return arr.reshape(n_threads, theta)


def _run_single(sched: Schedule, sc: Scenario, fab) -> float:
    """Run one flow on the fabric.

    A single flow has one sender, so its NIC stage is one serial chain —
    batching cannot widen it and the scalar path is always at least as
    fast (the fabrics compute identical values either way).  Batching
    pays off only in the multi-flow merges of :func:`_run_flows`.
    """
    return sched.run(sc, fab)


def _make_scenario(*, n_threads: int, theta: int, part_bytes: float,
                   ready, n_vcis: int, aggr_bytes: float, cfg: NetConfig,
                   src: int = 0, dst: int = 1) -> Scenario:
    return Scenario(n_threads=n_threads, theta=theta, part_bytes=part_bytes,
                    ready=_normalize_ready(n_threads, theta, ready),
                    n_vcis=n_vcis, aggr_bytes=aggr_bytes, cfg=cfg,
                    src=src, dst=dst)


def simulate(approach: str, *, n_threads: int, theta: int, part_bytes: float,
             ready=None, n_vcis: int = 1, aggr_bytes: float = 0.0,
             cfg: NetConfig = DEFAULT_NET, engine: str = "cuda",
             device="cuda") -> SimResult:
    """Run one iteration of the Fig-3 benchmark for one API variant.

    ``ready[t, j]`` is the time partition j of thread t finishes compute
    (seconds from MPI_Start).  The returned ``time_s`` subtracts the compute
    time ``max(ready)`` — the paper's §2.1 metric.  Dispatches through the
    ``SCHEDULES`` registry; ``engine`` selects the fabric (one of
    :data:`ENGINES`).
    """
    sched = _lookup(approach)
    sc = _make_scenario(n_threads=n_threads, theta=theta,
                        part_bytes=part_bytes, ready=ready, n_vcis=n_vcis,
                        aggr_bytes=aggr_bytes, cfg=cfg)
    fab = _make_fabric(engine, cfg, n_vcis, device=device)
    tts = _run_single(sched, sc, fab)
    return SimResult(time_s=tts - sc.compute, tts_s=tts,
                     n_messages=fab.n_messages, approach=approach)


@dataclass
class SteadyStateResult:
    """Multi-iteration run of one flow with a persistent request."""
    approach: str
    n_iters: int
    setup_s: float             # MPI_Psend_init / Win_create, paid once
    iter_times_s: List[float]  # per-iteration time minus compute
    tts_s: float               # absolute completion of the last iteration
    n_messages: int

    @property
    def first_iter_s(self) -> float:
        return self.iter_times_s[0]

    @property
    def steady_iter_s(self) -> float:
        """Warm-state per-iteration time (last iteration)."""
        return self.iter_times_s[-1]

    @property
    def amortized_s(self) -> float:
        """(setup + all iterations) / n — the figure of merit the paper's
        single-shot benchmark cannot express."""
        return (self.setup_s + sum(self.iter_times_s)) / self.n_iters

    def as_dict(self) -> dict:
        return {
            "scenario": "steady_state",
            "approach": self.approach,
            "n_iters": self.n_iters,
            "setup_us": self.setup_s / US,
            "first_iter_us": self.first_iter_s / US,
            "steady_iter_us": self.steady_iter_s / US,
            "amortized_us": self.amortized_s / US,
            "tts_us": self.tts_s / US,
            "n_messages": self.n_messages,
        }


def simulate_steady_state(approach: str, *, n_iters: int, n_threads: int,
                          theta: int, part_bytes: float, ready=None,
                          n_vcis: int = 1, aggr_bytes: float = 0.0,
                          cfg: NetConfig = DEFAULT_NET,
                          engine: str = "cuda",
                          device="cuda") -> SteadyStateResult:
    """N iterations of one flow, reusing the persistent request.

    Iteration 0 pays the one-time setup (``alpha_init`` plus
    ``alpha_init_msg`` per planned request/message — MPI_Psend_init builds
    the gcd/aggregation plan once); later iterations start at the previous
    completion with warm fabric state and settle to a constant cost.  The
    figure of merit is ``amortized_s``.  Note the warm per-iteration time
    can exceed the cold first iteration for multi-threaded schedules: once
    VCIs have owners, an iteration's first message per VCI pays the
    cross-thread lock bounce (``chi_switch``) where the one-shot benchmark
    paid the cheaper idle-VCI ``alpha_first`` — the steady-state number is
    the honest one.  A single flow takes the scalar path on every
    engine (:func:`_run_single`), so no engine launches a kernel here;
    ``device`` is still resolved, and asking for the card without one
    raises.
    """
    if n_iters <= 0:
        raise ValueError("n_iters must be positive")
    sched = _lookup(approach)
    sc = _make_scenario(n_threads=n_threads, theta=theta,
                        part_bytes=part_bytes, ready=ready, n_vcis=n_vcis,
                        aggr_bytes=aggr_bytes, cfg=cfg)
    fab = _make_fabric(engine, cfg, n_vcis, device=device)
    setup = cfg.alpha_init + cfg.alpha_init_msg * sched.n_requests(sc)
    t = setup
    iter_times = []
    for _ in range(n_iters):
        sc.t0 = t
        tts = _run_single(sched, sc, fab)
        iter_times.append(tts - t - sc.compute)
        t = tts
    return SteadyStateResult(approach=approach, n_iters=n_iters,
                             setup_s=setup, iter_times_s=iter_times,
                             tts_s=t, n_messages=fab.n_messages)


@dataclass
class HaloResult:
    """1-D halo exchange between R simulated ranks."""
    approach: str
    n_ranks: int
    periodic: bool
    rank_tts_s: List[float]    # per-rank completion (all halos received)
    time_s: float              # max completion minus compute
    tts_s: float
    n_messages: int

    @property
    def time_us(self) -> float:
        return self.time_s / US

    def as_dict(self) -> dict:
        return {
            "scenario": "halo",
            "approach": self.approach,
            "n_ranks": self.n_ranks,
            "periodic": self.periodic,
            "time_us": self.time_us,
            "tts_us": self.tts_s / US,
            "rank_tts_us": [t / US for t in self.rank_tts_s],
            "n_messages": self.n_messages,
        }


def _run_flows_reference(sched: Schedule, fab: ReferenceFabric,
                         scenarios: Sequence[Scenario]) -> List[List[float]]:
    """Scalar-oracle multi-flow merge: one transmit call per message.

    Pipelinable flows merge their intents in global time order so
    concurrent flows interleave on shared VCIs/NICs/links instead of
    queueing behind one another's last injection (stable across flows on
    ties).  Dependent-traffic schedules (RMA epochs) run whole, in
    enumeration order.  Returns, per rank, the finish time of each flow
    arriving at that rank.
    """
    incoming: List[List[float]] = [[] for _ in range(fab.n_ranks)]
    flows = []
    for sc in scenarios:
        ints = sched.intents(sc)
        if ints is None:
            incoming[sc.dst].append(sched.run(sc, fab))
        else:
            flows.append((sc, ints))
    events = sorted(((i.t_ready, f, p) for f, (_, ints) in enumerate(flows)
                     for p, i in enumerate(ints)),
                    key=lambda e: e[0])
    arrivals: List[List[float]] = [[] for _ in flows]
    for _, f, p in events:
        sc, ints = flows[f]
        i = ints[p]
        arrivals[f].append(fab.transmit(i.t_ready, i.nbytes, vci=i.vci,
                                        thread=i.thread, put=i.put,
                                        am_copy=i.am_copy,
                                        src=sc.src, dst=sc.dst))
    for f, (sc, _) in enumerate(flows):
        incoming[sc.dst].append(sched.finish(sc, fab, arrivals[f]))
    return incoming


def _scenario_class_key(sc: Scenario) -> tuple:
    """Scenario equivalence class for intent memoization.

    Intents depend on everything about a flow *except* its (src, dst)
    endpoints — flows sharing this key (e.g. every stencil flow of one
    dimension) reuse one intent batch, re-stamped per endpoint pair.
    Drivers that know their classes up front set ``Scenario.class_key``;
    the fallback hashes the full parameter tuple (ready table included).
    """
    if sc.class_key is not None:
        return sc.class_key
    return (sc.n_threads, sc.theta, sc.part_bytes, sc.n_vcis,
            sc.aggr_bytes, sc.t0, id(sc.cfg), sc.ready.tobytes())


# Process-wide merge-layout memo: the stable argsort permutation of a
# multi-flow merge is a pure function of the flows' intent classes and
# endpoints, so re-running an identical merge (benchmark repeats,
# smoke-vs-full shared points, repeated scenario evaluations) skips the
# O(n log n) re-sort entirely.  Keys embed every scenario parameter that
# shapes the columns — including the NetConfig *values*, so recycled
# object ids can never alias two different configurations.
_MERGE_MEMO = CappedMemo(64)


def clear_merge_memo() -> None:
    """Reset the merge-order, assembled-grid-point and the torch/cuda
    engines' stage-layout/bucket/operand memos with their counters, so
    a following run starts cold."""
    _MERGE_MEMO.clear()
    _GRID_MEMO.clear()
    fabric_torch.clear_layout_memo()
    fabric_cuda.clear_memos()


def _merge_order(t_ready: np.ndarray,
                 memo_key: Optional[tuple]) -> np.ndarray:
    """The merge's stable sort permutation, memoized per merge key."""
    order = _MERGE_MEMO.get(memo_key)
    if order is not None:
        return order
    order = np.argsort(t_ready, kind="stable")
    _MERGE_MEMO.put(memo_key, order)
    return order


def _flows_memo_key(sched: Schedule, flows: Sequence[Scenario],
                    srcs: np.ndarray, dsts: np.ndarray) -> tuple:
    """Merge-memo key for a generic flow list.

    Deliberately *not* built from ``Scenario.class_key``: driver-set
    keys like ``(dim, rank)`` only disambiguate flows within one driver
    call.  A process-level key must embed every parameter that shapes
    the columns — per flow, NetConfig *values* included, so neither a
    recycled ``id(cfg)`` nor a different cfg-to-flow assignment can
    alias two merges.
    """
    fkeys = tuple((sc.n_threads, sc.theta, sc.part_bytes, sc.n_vcis,
                   sc.aggr_bytes, sc.t0, sc.cfg, sc.ready.tobytes())
                  for sc in flows)
    return ("flows", sched.name, fkeys,
            srcs.tobytes(), dsts.tobytes())


def _merge_transmit(sched: Schedule, fab: Fabric,
                    flows: Sequence[Scenario], lens: np.ndarray,
                    t_ready: np.ndarray, nbytes: np.ndarray, vci: np.ndarray,
                    thread: np.ndarray, put: np.ndarray, am_copy: np.ndarray,
                    src: np.ndarray, dst: np.ndarray,
                    memo_key: Optional[tuple] = None
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The shared merge pipeline behind both batched flow paths.

    Takes per-message columns in flow-major order plus per-flow lengths;
    merges all flows in global time order (stable sort by t_ready — the
    identical order, tie-breaks included, to the scalar event loop),
    runs the fabric once, and computes per-flow finish times.  Returns
    ``(finished, arrivals, starts)`` with arrivals back in flow-major
    order.  ``memo_key`` (when the caller can name the merge's
    equivalence class) reuses the hoisted argsort permutation and, on
    the torch/cuda engines, the fabric's stage layouts.  This is the single
    bit-for-bit-critical copy of the merge: ordering or finish fixes
    land here for every caller.
    """
    order = _merge_order(t_ready, memo_key)
    arr = fab.transmit_arrays(t_ready[order], nbytes[order], vci[order],
                              thread[order], put[order], am_copy[order],
                              src[order], dst[order], layout_key=memo_key)
    arrivals = np.empty_like(arr)
    arrivals[order] = arr
    finished, starts = _finish_flows(sched, fab, flows, lens, arrivals)
    return finished, arrivals, starts


def _finish_flows(sched: Schedule, fab, flows: Sequence[Scenario],
                  lens: np.ndarray, arrivals: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-flow finish times from flow-major arrivals — the single copy
    of the post-transmit arithmetic (flow-max reduction + finish) shared
    by :func:`_merge_transmit` and the whole-grid path, so a finish fix
    reaches every batched caller."""
    starts = np.zeros(len(flows), dtype=np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    flow_max = np.maximum.reduceat(arrivals, starts)
    finished = sched.finish_batch(flows, fab, flow_max)
    if finished is None:  # custom finish: per-flow calls on slices
        finished = np.array(
            [sched.finish(sc, fab, arrivals[o:o + ln])
             for sc, o, ln in zip(flows, starts.tolist(), lens.tolist())])
    return finished, starts


def _run_flows_vector(sched: Schedule, fab: Fabric,
                      scenarios: Sequence[Scenario]) -> List[List[float]]:
    """Batched multi-flow merge: memoized intent batches, one stable
    argsort over all flows, one grouped-scan pass through the fabric.

    Equivalent to :func:`_run_flows_reference` bit-for-bit: dependent
    -traffic flows still run whole first (scalar transmits on the shared
    array state), and the merged batch is processed in the identical
    global order (stable sort by t_ready over flow-major enumeration).
    """
    incoming: List[List[float]] = [[] for _ in range(fab.n_ranks)]
    flows: List[Scenario] = []
    batches: List[IntentBatch] = []
    memo: Dict[tuple, Optional[IntentBatch]] = {}
    for sc in scenarios:
        key = _scenario_class_key(sc)
        if key not in memo:
            memo[key] = sched.intent_batch(sc)
        batch = memo[key]
        if batch is None:
            incoming[sc.dst].append(sched.run(sc, fab))
        else:
            flows.append(sc)
            batches.append(batch)
    if flows:
        lens = np.array([len(b) for b in batches], dtype=np.int64)
        srcs = np.array([sc.src for sc in flows], dtype=np.int64)
        dsts = np.array([sc.dst for sc in flows], dtype=np.int64)
        finished, _, _ = _merge_transmit(
            sched, fab, flows, lens,
            np.concatenate([b.t_ready for b in batches]),
            np.concatenate([b.nbytes for b in batches]),
            np.concatenate([b.vci for b in batches]),
            np.concatenate([b.thread for b in batches]),
            np.concatenate([b.put for b in batches]),
            np.concatenate([b.am_copy for b in batches]),
            np.repeat(srcs, lens), np.repeat(dsts, lens),
            memo_key=_flows_memo_key(sched, flows, srcs, dsts))
        for sc, t in zip(flows, finished.tolist()):
            incoming[sc.dst].append(t)
    return incoming


def _run_flows(sched: Schedule, fab,
               scenarios: Sequence[Scenario]) -> List[List[float]]:
    """Run many flows of one schedule on a shared fabric (engine dispatch)."""
    if isinstance(fab, Fabric):
        return _run_flows_vector(sched, fab, scenarios)
    return _run_flows_reference(sched, fab, scenarios)


def _assemble_classes(sched: Schedule, templates: Sequence[Scenario],
                      class_idx: np.ndarray, srcs: np.ndarray,
                      dsts: np.ndarray
                      ) -> Optional[Tuple[List[Scenario], np.ndarray,
                                          Dict[str, np.ndarray], tuple]]:
    """Assemble flow-major merged columns for class-stamped flows.

    ``class_idx[i]`` names the template scenario flow i is an endpoint
    re-stamp of.  Intent batches are built once per class; the merged
    columns are assembled by vectorized gathers instead of per-flow
    Python objects, so a 512-rank stencil (3072 flows) costs a handful
    of array ops.  Returns ``(flows, lens, cols, memo_key)`` — flows are
    template references (enough for the uniform ``finish_batch``) — or
    None when the schedule has dependent traffic or a custom per-flow
    finish (the caller then takes the generic per-scenario path).
    """
    if sched.finish_batch([], None, np.empty(0)) is None:
        return None  # custom per-flow finish: needs real endpoint pairs
    batches = [sched.intent_batch(t) for t in templates]
    if any(b is None for b in batches):
        return None
    class_len = np.array([len(b) for b in batches], dtype=np.int64)
    class_ofs = np.zeros(len(batches), dtype=np.int64)
    np.cumsum(class_len[:-1], out=class_ofs[1:])
    lens = class_len[class_idx]
    n = int(lens.sum())
    flow_starts = np.zeros(len(class_idx), dtype=np.int64)
    np.cumsum(lens[:-1], out=flow_starts[1:])
    # gather[i] = row of the stacked class columns feeding message i of
    # the flow-major concatenation (what per-flow np.concatenate built)
    gather = (np.repeat(class_ofs[class_idx] - flow_starts, lens)
              + np.arange(n, dtype=np.int64))
    flows = [templates[c] for c in class_idx.tolist()]
    cols = {
        "t_ready": np.concatenate([b.t_ready for b in batches])[gather],
        "nbytes": np.concatenate([b.nbytes for b in batches])[gather],
        "vci": np.concatenate([b.vci for b in batches])[gather],
        "thread": np.concatenate([b.thread for b in batches])[gather],
        "put": np.concatenate([b.put for b in batches])[gather],
        "am_copy": np.concatenate([b.am_copy for b in batches])[gather],
        "src": np.repeat(srcs, lens),
        "dst": np.repeat(dsts, lens),
    }
    # per-template params with the NetConfig values inline: a different
    # cfg-to-template assignment must never alias an earlier merge
    memo_key = ("classes", sched.name,
                tuple((t.n_threads, t.theta, t.part_bytes, t.n_vcis,
                       t.aggr_bytes, t.t0, t.cfg, t.ready.tobytes())
                      for t in templates),
                class_idx.tobytes(), srcs.tobytes(), dsts.tobytes())
    return flows, lens, cols, memo_key


def _run_flows_classes(sched: Schedule, fab: Fabric,
                       templates: Sequence[Scenario],
                       class_idx: np.ndarray, srcs: np.ndarray,
                       dsts: np.ndarray) -> Optional[np.ndarray]:
    """Class-based fast path for many flows drawn from few intent classes.

    Assembles the merged columns once (:func:`_assemble_classes`) and
    runs the shared merge.  Returns per-rank completion times, or None
    when the schedule cannot be class-batched.  Bit-for-bit equal to
    :func:`_run_flows_reference`: same concatenation order, same stable
    merge, same finish arithmetic.
    """
    asm = _assemble_classes(sched, templates, class_idx, srcs, dsts)
    if asm is None:
        return None
    flows, lens, cols, memo_key = asm
    finished, _, _ = _merge_transmit(
        sched, fab, flows, lens,
        cols["t_ready"], cols["nbytes"], cols["vci"], cols["thread"],
        cols["put"], cols["am_copy"], cols["src"], cols["dst"],
        memo_key=memo_key)
    rank_tts = np.zeros(fab.n_ranks)
    np.maximum.at(rank_tts, dsts, finished)
    return rank_tts


def simulate_halo(approach: str, *, n_ranks: int, theta: int,
                  part_bytes: float, n_threads: int = 1, ready=None,
                  n_vcis: int = 1, aggr_bytes: float = 0.0,
                  periodic: bool = True,
                  cfg: NetConfig = DEFAULT_NET,
                  engine: str = "cuda", device="cuda") -> HaloResult:
    """1-D stencil halo exchange: every rank sends its theta boundary
    partitions to each neighbor and completes when both halos arrive.

    Each (rank -> neighbor) direction is one flow of the registered
    schedule, all sharing one R-rank fabric — so both directions of a link
    and both flows out of a rank contend for the rank's VCIs/NIC exactly
    as the sender of the paper's benchmark does.  ``ready`` has the usual
    (n_threads, theta) shape and applies per rank (bulk-synchronous
    stencil step).  The 1-D special case of :func:`simulate_stencil`,
    kept for its exact partition-size semantics and flat result shape.
    """
    if n_ranks < 2:
        raise ValueError("halo exchange needs at least 2 ranks")
    sched = _lookup(approach)
    topo = CartTopology.create((n_ranks,), periodic)
    fab = _make_fabric(engine, cfg, n_vcis, n_ranks=n_ranks, device=device)
    ready_arr = _normalize_ready(n_threads, theta, ready)
    compute = float(ready_arr.max())
    scenarios = [Scenario(n_threads=n_threads, theta=theta,
                          part_bytes=part_bytes, ready=ready_arr,
                          n_vcis=n_vcis, aggr_bytes=aggr_bytes, cfg=cfg,
                          src=flow.src, dst=flow.dst)
                 for flow in topo.flows()]
    incoming = _run_flows(sched, fab, scenarios)
    rank_tts = [max(arr) if arr else 0.0 for arr in incoming]
    tts = max(rank_tts)
    return HaloResult(approach=approach, n_ranks=n_ranks, periodic=periodic,
                      rank_tts_s=rank_tts, time_s=tts - compute, tts_s=tts,
                      n_messages=fab.n_messages)


@dataclass
class StencilResult:
    """N-D Cartesian stencil halo exchange over a rank grid."""
    approach: str
    dims: tuple
    periodic: tuple
    face_bytes: tuple          # per-dimension face payload, bytes
    rank_tts_s: List[float]    # per-rank completion (all faces received)
    sent_per_rank: List[int]   # wire messages injected by each rank
    time_s: float              # max completion minus compute
    tts_s: float
    n_messages: int

    @property
    def n_ranks(self) -> int:
        return len(self.rank_tts_s)

    @property
    def time_us(self) -> float:
        return self.time_s / US

    def as_dict(self) -> dict:
        return {
            "scenario": "stencil",
            "approach": self.approach,
            "dims": list(self.dims),
            "periodic": list(self.periodic),
            "n_ranks": self.n_ranks,
            "face_bytes": list(self.face_bytes),
            "time_us": self.time_us,
            "tts_us": self.tts_s / US,
            "rank_tts_us": [t / US for t in self.rank_tts_s],
            "sent_per_rank": list(self.sent_per_rank),
            "n_messages": self.n_messages,
        }


def _normalize_rank_ready(n_ranks: int, n_threads: int, theta: int,
                          ready) -> np.ndarray:
    """Broadcast ``ready`` to (n_ranks, n_threads, theta): None (all
    zeros), one (n_threads, theta) table shared by every rank, or a full
    per-rank table."""
    if ready is None:
        return np.zeros((n_ranks, n_threads, theta))
    arr = np.asarray(ready, dtype=float)
    if arr.size == n_threads * theta:
        return np.broadcast_to(arr.reshape(n_threads, theta),
                               (n_ranks, n_threads, theta))
    if arr.size != n_ranks * n_threads * theta:
        raise ValueError(
            f"per-rank ready table has shape {arr.shape} ({arr.size}"
            f" entries); expected (n_ranks, n_threads, theta) ="
            f" ({n_ranks}, {n_threads}, {theta}) or a shared"
            f" (n_threads, theta) = ({n_threads}, {theta}) table")
    return arr.reshape(n_ranks, n_threads, theta)


def _stencil_setup(approach, *, dims, topo, periodic, theta, n_threads,
                   local_shape, bytes_per_cell, halo_width, face_bytes,
                   ready):
    """Shared validation/derivation for the stencil paths: the topology,
    per-dimension face sizes, schedule lookup, and the (broadcast) ready
    table.  ``shared_ready`` is True when every rank shares one table —
    one intent-equivalence class per dimension."""
    if topo is None:
        topo = CartTopology.create(dims, periodic)
    if topo.n_ranks < 2:
        raise ValueError("stencil exchange needs at least 2 ranks")
    if face_bytes is None:
        if local_shape is None:
            raise ValueError("need local_shape (or explicit face_bytes)")
        spec = HaloSpec.create(topo, local_shape, bytes_per_cell, halo_width)
        face_bytes = spec.all_face_bytes()
    else:
        face_bytes = tuple(float(b) for b in face_bytes)
        if len(face_bytes) != topo.n_dims:
            raise ValueError("need one face size per dimension")
    sched = _lookup(approach)
    # Shared (or absent) ready tables mean one intent-equivalence class
    # per dimension; per-rank tables refine that to (dimension, rank).
    shared_ready = ready is None or \
        np.asarray(ready).size == n_threads * theta
    ready_arr = _normalize_rank_ready(topo.n_ranks, n_threads, theta, ready)
    return topo, face_bytes, sched, shared_ready, ready_arr


def simulate_stencil(approach: str, *, dims: Sequence[int] = (),
                     topo: Optional[CartTopology] = None,
                     periodic=True, theta: int, n_threads: int = 1,
                     local_shape: Optional[Sequence[int]] = None,
                     bytes_per_cell: float = 8.0, halo_width: int = 1,
                     face_bytes: Optional[Sequence[float]] = None,
                     ready=None, n_vcis: int = 1, aggr_bytes: float = 0.0,
                     cfg: NetConfig = DEFAULT_NET,
                     engine: str = "cuda", device="cuda") -> StencilResult:
    """N-dimensional Cartesian stencil halo exchange.

    The rank grid comes from ``topo`` (or ``dims`` + ``periodic``); every
    rank runs one flow of the registered schedule per face neighbor, all
    merged in global time order on one shared fabric.  The payload of the
    face perpendicular to dimension d is ``face_bytes[d]``, normally
    derived from a rank-local cell block via :class:`HaloSpec`
    (``local_shape`` x ``bytes_per_cell`` x ``halo_width``) — anisotropic
    blocks exercise per-dimension message sizes spanning the protocol
    switches.  Each face is split into ``n_threads * theta`` partitions
    whose wire plan (aggregation, channel map) the schedule builds through
    the flow's CommPlan, exactly as in the paper's benchmark.

    ``ready`` is None, one (n_threads, theta) table applied to every rank,
    or (n_ranks, n_threads, theta) per-rank tables (load imbalance).
    """
    topo, face_bytes, sched, shared_ready, ready_arr = _stencil_setup(
        approach, dims=dims, topo=topo, periodic=periodic, theta=theta,
        n_threads=n_threads, local_shape=local_shape,
        bytes_per_cell=bytes_per_cell, halo_width=halo_width,
        face_bytes=face_bytes, ready=ready)
    fab = _make_fabric(engine, cfg, n_vcis, n_ranks=topo.n_ranks,
                       device=device)
    compute = float(ready_arr.max())
    n_part = n_threads * theta
    srcs, dsts, fdims = topo.flow_arrays()
    dim_bytes = [face_bytes[d] / n_part for d in range(topo.n_dims)]
    rank_tts = None
    if isinstance(fab, Fabric) and shared_ready:
        # one intent class per dimension: build each batch once and
        # re-stamp it per (src, dst) with vectorized gathers
        templates = [Scenario(n_threads=n_threads, theta=theta,
                              part_bytes=dim_bytes[d], ready=ready_arr[0],
                              n_vcis=n_vcis, aggr_bytes=aggr_bytes, cfg=cfg)
                     for d in range(topo.n_dims)]
        tts_arr = _run_flows_classes(sched, fab, templates, fdims,
                                     srcs, dsts)
        if tts_arr is not None:
            rank_tts = tts_arr.tolist()
    if rank_tts is None:  # per-rank ready tables or dependent traffic
        scenarios = [Scenario(n_threads=n_threads, theta=theta,
                              part_bytes=dim_bytes[d],
                              ready=ready_arr[s], n_vcis=n_vcis,
                              aggr_bytes=aggr_bytes, cfg=cfg,
                              src=int(s), dst=int(t),
                              class_key=(d,) if shared_ready else (d, int(s)))
                     for s, t, d in zip(srcs, dsts, fdims)]
        incoming = _run_flows(sched, fab, scenarios)
        rank_tts = [max(arr) if arr else 0.0 for arr in incoming]
    tts = max(rank_tts)
    return StencilResult(approach=approach, dims=topo.dims,
                         periodic=topo.periodic, face_bytes=tuple(face_bytes),
                         rank_tts_s=rank_tts,
                         sent_per_rank=list(fab.sent_per_rank),
                         time_s=tts - compute, tts_s=tts,
                         n_messages=fab.n_messages)


# Assembled-and-sorted grid points, keyed by their full parameter set:
# repeated whole-grid evaluations (benchmark repeats, shared smoke/full
# points) skip re-assembly entirely and go straight to the device.  The
# entries hold host arrays only, so every device and engine shares them.
_GRID_MEMO = CappedMemo(32)


@dataclass
class _PreparedStencil:
    """One stencil sweep point, assembled up to (but not including) the
    fabric advance — the unit the whole-grid path stacks."""
    approach: str
    sched: Schedule
    flows: List[Scenario]          # template refs per flow (finish_batch)
    lens: np.ndarray               # per-flow wire-message counts
    cols: Dict[str, np.ndarray]    # flow-major merged message columns
    dsts: np.ndarray               # per-flow destination rank
    n_ranks: int
    n_vcis: int
    cfg: NetConfig
    compute: float
    dims: tuple
    periodic: tuple
    face_bytes: tuple
    memo_key: tuple


def _prepare_stencil(approach: str, *, dims: Sequence[int] = (),
                     topo: Optional[CartTopology] = None, periodic=True,
                     theta: int, n_threads: int = 1,
                     local_shape: Optional[Sequence[int]] = None,
                     bytes_per_cell: float = 8.0, halo_width: int = 1,
                     face_bytes: Optional[Sequence[float]] = None,
                     ready=None, n_vcis: int = 1, aggr_bytes: float = 0.0,
                     cfg: NetConfig = DEFAULT_NET
                     ) -> Optional[_PreparedStencil]:
    """Assemble one stencil point for the whole-grid path, or None when
    it cannot be batched (per-rank ready tables, dependent traffic, or a
    custom per-flow finish) — the caller then falls back to the
    per-point drivers."""
    topo, face_bytes, sched, shared_ready, ready_arr = _stencil_setup(
        approach, dims=dims, topo=topo, periodic=periodic, theta=theta,
        n_threads=n_threads, local_shape=local_shape,
        bytes_per_cell=bytes_per_cell, halo_width=halo_width,
        face_bytes=face_bytes, ready=ready)
    if not shared_ready:
        return None
    n_part = n_threads * theta
    srcs, dsts, fdims = topo.flow_arrays()
    templates = [Scenario(n_threads=n_threads, theta=theta,
                          part_bytes=face_bytes[d] / n_part,
                          ready=ready_arr[0], n_vcis=n_vcis,
                          aggr_bytes=aggr_bytes, cfg=cfg)
                 for d in range(topo.n_dims)]
    asm = _assemble_classes(sched, templates, fdims, srcs, dsts)
    if asm is None:
        return None
    flows, lens, cols, memo_key = asm
    return _PreparedStencil(
        approach=approach, sched=sched, flows=flows, lens=lens, cols=cols,
        dsts=dsts, n_ranks=topo.n_ranks, n_vcis=n_vcis, cfg=cfg,
        compute=float(ready_arr.max()), dims=topo.dims,
        periodic=topo.periodic, face_bytes=tuple(face_bytes),
        memo_key=memo_key)


def _finish_prepared(prep: _PreparedStencil,
                     arrivals: np.ndarray) -> StencilResult:
    """Reduce one grid point's flow-major arrival times to its result:
    the same per-flow finish and per-rank max as the per-point driver
    (via the shared :func:`_finish_flows`)."""
    finished, _ = _finish_flows(prep.sched, None, prep.flows, prep.lens,
                                arrivals)
    rank_tts = np.zeros(prep.n_ranks)
    np.maximum.at(rank_tts, prep.dsts, finished)
    tts = float(rank_tts.max())
    sent = np.bincount(prep.cols["src"], minlength=prep.n_ranks)
    return StencilResult(
        approach=prep.approach, dims=prep.dims, periodic=prep.periodic,
        face_bytes=prep.face_bytes, rank_tts_s=rank_tts.tolist(),
        sent_per_rank=sent.tolist(), time_s=tts - prep.compute, tts_s=tts,
        n_messages=int(prep.lens.sum()))


def _cuda_finish_spec(prep: _PreparedStencil, order: np.ndarray
                      ) -> Optional[fabric_cuda.FinishSpec]:
    """The point's device-side finish reduction, or None when its finish
    is not affine (the cuda path then falls back to arrivals mode + the
    host-side :func:`_finish_prepared`).

    Affinity is established by probing ``finish_batch`` at 0 and 1:
    ``finish(x) == x + finish(0)`` elementwise (bitwise under IEEE-754 —
    one commutative add) certifies the kernel's ``flow_max + offset``
    reproduces the host reduction exactly.
    """
    F = len(prep.lens)
    if F == 0 or np.any(prep.lens <= 0):
        return None
    foff = prep.sched.finish_batch(prep.flows, None, np.zeros(F))
    if foff is None:
        return None
    probe = prep.sched.finish_batch(prep.flows, None, np.ones(F))
    if probe is None or not np.array_equal(probe, 1.0 + foff):
        return None
    fid = np.repeat(np.arange(F, dtype=np.int64), prep.lens)[order]
    return fabric_cuda.FinishSpec(
        fid=fid, foff=np.asarray(foff, dtype=np.float64),
        fdst=prep.dsts.astype(np.int64), n_ranks=prep.n_ranks)


def _result_from_rank_tts(prep: _PreparedStencil, aux: dict,
                          rank_tts: np.ndarray) -> StencilResult:
    """Build one grid point's result from device-side per-rank times."""
    if "sent" not in aux:
        aux["sent"] = np.bincount(prep.cols["src"],
                                  minlength=prep.n_ranks).tolist()
    tts = float(rank_tts.max())
    return StencilResult(
        approach=prep.approach, dims=prep.dims, periodic=prep.periodic,
        face_bytes=prep.face_bytes, rank_tts_s=rank_tts.tolist(),
        sent_per_rank=list(aux["sent"]), time_s=tts - prep.compute,
        tts_s=tts, n_messages=int(prep.lens.sum()))


def _grid_entries(points: Sequence[Mapping]) -> List[Optional[tuple]]:
    """Each point assembled, merge-sorted and packed as a
    :class:`~repro_torch.core.fabric_torch.GridItem` (memoized): one
    ``(prep, order, item, aux)`` entry per point, None where the batched
    path cannot evaluate it.  ``aux`` accumulates engine-lazy per-point
    state (the cuda finish spec, sent-per-rank counts)."""
    prepared: List[Optional[tuple]] = []
    for p in points:
        try:  # hashable param sets reuse the assembled + sorted point
            pkey = ("stencil-point", tuple(sorted(p.items())))
            hash(pkey)
        except TypeError:  # e.g. ndarray-valued ready tables
            pkey = None
        entry = _GRID_MEMO.get(pkey)
        if entry is None:
            prep = _prepare_stencil(**p)
            if prep is None:
                prepared.append(None)
                continue
            order = _merge_order(prep.cols["t_ready"], prep.memo_key)
            c = prep.cols
            item = fabric_torch.GridItem(
                t_ready=c["t_ready"][order], nbytes=c["nbytes"][order],
                vci=c["vci"][order], thread=c["thread"][order],
                put=c["put"][order], am_copy=c["am_copy"][order],
                src=c["src"][order], dst=c["dst"][order],
                cfg=prep.cfg, n_vcis=prep.n_vcis, n_ranks=prep.n_ranks,
                key=prep.memo_key)
            entry = (prep, order, item, {})
            _GRID_MEMO.put(pkey, entry)
        prepared.append(entry)
    return prepared


def simulate_stencil_grid(points: Sequence[Mapping], engine: str = "cuda",
                          device="cuda") -> List[Optional[StencilResult]]:
    """Evaluate many stencil sweep points as one grid on the device.

    Each entry of ``points`` is a kwargs mapping for
    :func:`simulate_stencil` (``approach`` included, ``engine`` and
    ``device`` absent — they are this function's arguments).  Points are
    assembled into stamped intent-batch columns and merged with memoized
    sorts; the advance is then ``engine="torch"`` —
    :func:`repro_torch.core.fabric_torch.transmit_grid`, one batched
    pipeline call per rank-grid shape — or ``engine="cuda"`` — the
    kernel super-batch of :mod:`repro_torch.core.fabric_cuda`, which also
    runs each point's (affine) finish reduction on the device and returns
    per-rank times directly.  Returns one :class:`StencilResult` per
    point, with None for points the batched path cannot evaluate (the
    caller falls back to :func:`simulate_stencil`).  Both engines are
    bit-for-bit identical to the per-point engines.
    """
    if engine not in GRID_ENGINES:
        raise ValueError(
            f"unknown grid engine {engine!r}; one of {GRID_ENGINES}")
    dev = resolve_device(device)
    prepared = _grid_entries(points)
    results: List[Optional[StencilResult]] = [None] * len(prepared)
    live = [(i, e) for i, e in enumerate(prepared) if e is not None]
    if engine == "cuda":
        # split points by finish affinity: affine points reduce to
        # per-rank times on the device, the rest return arrivals
        fin_members, arr_members = [], []
        for i, (prep, order, item, aux) in live:
            if "finish" not in aux:
                aux["finish"] = _cuda_finish_spec(prep, order)
            (fin_members if aux["finish"] is not None
             else arr_members).append((i, prep, order, item, aux))
        if fin_members:
            rank_tts = fabric_cuda.transmit_grid_finish(
                [m[3] for m in fin_members],
                [m[4]["finish"] for m in fin_members], dev)
            for (i, prep, _, _, aux), tts in zip(fin_members, rank_tts):
                results[i] = _result_from_rank_tts(prep, aux, tts)
        if arr_members:
            arrs = fabric_cuda.transmit_grid([m[3] for m in arr_members],
                                             dev)
            for (i, prep, order, _, _), sorted_arr in zip(arr_members,
                                                          arrs):
                arrivals = np.empty_like(sorted_arr)
                arrivals[order] = sorted_arr
                results[i] = _finish_prepared(prep, arrivals)
        return results
    arrs = iter(fabric_torch.transmit_grid([e[2] for _, e in live], dev))
    for i, (prep, order, _, _) in live:
        sorted_arr = next(arrs)
        arrivals = np.empty_like(sorted_arr)
        arrivals[order] = sorted_arr
        results[i] = _finish_prepared(prep, arrivals)
    return results


@dataclass
class ImbalanceResult:
    """Ring exchange under the Appendix-A per-rank compute-noise model."""
    approach: str
    n_ranks: int
    theta: int
    seed: int
    mean_delay_s: float        # mean over ranks of the empirical ready
    #                            spread (last - first partition ready)
    model_delay_s: float       # eq (8): Workload.delay_seconds(theta, S)
    rank_tts_s: List[float]
    time_s: float
    tts_s: float
    n_messages: int

    @property
    def time_us(self) -> float:
        return self.time_s / US

    def as_dict(self) -> dict:
        return {
            "scenario": "imbalance",
            "approach": self.approach,
            "n_ranks": self.n_ranks,
            "theta": self.theta,
            "seed": self.seed,
            "mean_delay_us": self.mean_delay_s / US,
            "model_delay_us": self.model_delay_s / US,
            "time_us": self.time_us,
            "tts_us": self.tts_s / US,
            "rank_tts_us": [t / US for t in self.rank_tts_s],
            "n_messages": self.n_messages,
        }


def simulate_imbalance(approach: str, *, n_ranks: int, workload, theta: int,
                       part_bytes: float, n_threads: int = 1,
                       n_vcis: int = 1, aggr_bytes: float = 0.0,
                       periodic: bool = True, seed: int = 0,
                       cfg: NetConfig = DEFAULT_NET,
                       engine: str = "cuda",
                       device="cuda") -> ImbalanceResult:
    """Ring halo exchange with per-rank load imbalance from the paper's
    noise model.

    Every rank draws its own (n_threads, theta) ready table from
    ``workload.sample_ready`` — per-partition compute ``mu * S * N(1,
    sigma)`` with ``sigma = (eps + delta) / 2`` accumulated along each
    thread — so ranks finish compute at different times and the early-bird
    injection of ready partitions is exercised against *stochastic* delays
    rather than Fig 8's single deterministic one.  ``mean_delay_s``
    reports the empirical spread between first and last partition-ready
    time, averaged over ranks; the analytic counterpart is eq (8)'s
    ``model_delay_s`` — the cross-validation tests hold the two together.
    """
    rng = np.random.default_rng(seed)
    ready = np.stack([
        workload.sample_ready(n_threads, theta, part_bytes, rng)
        for _ in range(n_ranks)])
    r = simulate_stencil(approach, dims=(n_ranks,), periodic=periodic,
                         theta=theta, n_threads=n_threads,
                         face_bytes=(n_threads * theta * part_bytes,),
                         ready=ready, n_vcis=n_vcis, aggr_bytes=aggr_bytes,
                         cfg=cfg, engine=engine, device=device)
    delays = ready.max(axis=(1, 2)) - ready.min(axis=(1, 2))
    return ImbalanceResult(approach=approach, n_ranks=n_ranks, theta=theta,
                           seed=seed, mean_delay_s=float(delays.mean()),
                           model_delay_s=workload.delay_seconds(
                               theta, part_bytes),
                           rank_tts_s=r.rank_tts_s, time_s=r.time_s,
                           tts_s=r.tts_s, n_messages=r.n_messages)


def _tail_quantile(values: np.ndarray, q: float) -> float:
    """Order-statistic quantile: the smallest sample at or above rank
    ``q * (n - 1)``.  Always an actual sample (no interpolation), so the
    committed tail metrics are reproducible across numpy versions."""
    n = values.shape[0]
    k = min(n - 1, int(np.ceil(q * (n - 1))))
    return float(np.sort(values)[k])


@dataclass
class ServingResult:
    """Open-loop trace-driven serving run: tail latency + goodput.

    ``latency_s`` covers *completed* requests only; with overload
    protection active (``queue_depth`` / ``deadline_us``) the shed ones
    are counted in ``n_shed`` and excluded from the tails, which is the
    point — shedding trades completed-request count for a bounded tail.
    ``goodput_retention`` is the fraction of offered requests that
    completed within the deadline (all completed requests when no
    deadline is set).
    """
    approach: str
    arrival: str               # arrival model name (core/arrivals.py)
    n_requests: int            # offered requests (the trace length)
    n_tenants: int
    n_stages: int
    offered_rps: float         # empirical offered load of the trace
    latency_s: np.ndarray      # per-request arrival -> last-stage latency
    tts_s: float               # absolute completion of the last request
    n_messages: int
    n_waves: int               # admission waves fed to fab.advance
    n_retransmits: int = 0     # dropped messages re-queued (faults only)
    retrans_bytes: float = 0.0  # payload re-sent by those retransmissions
    policy: str = "fixed"      # recovery policy (core/recovery.py)
    n_shed: int = 0            # requests shed at admission / past deadline
    n_completed: Optional[int] = None   # None: every request completed
    n_good: Optional[int] = None        # completed within the deadline
    n_hedges: int = 0          # hedge timers fired (hedged policy)
    n_suppressed: int = 0      # duplicate deliveries suppressed
    duplicate_bytes: float = 0.0  # wasted payload of suppressed hedges

    @property
    def completed(self) -> int:
        return (self.n_completed if self.n_completed is not None
                else self.n_requests)

    @property
    def goodput_rps(self) -> float:
        """Completed requests per second of *fabric* time: completions
        over the first-arrival -> last-completion makespan.  Tracks the
        offered load while the fabric keeps up and saturates at the
        fabric's drain rate once queueing compounds."""
        return self.completed / self.tts_s if self.tts_s > 0.0 else 0.0

    @property
    def goodput_retention(self) -> float:
        """Fraction of offered requests that completed in time."""
        good = self.n_good if self.n_good is not None else self.completed
        return good / self.n_requests if self.n_requests else 0.0

    @property
    def p50_s(self) -> float:
        return _tail_quantile(self.latency_s, 0.50) \
            if self.latency_s.size else 0.0

    @property
    def p99_s(self) -> float:
        return _tail_quantile(self.latency_s, 0.99) \
            if self.latency_s.size else 0.0

    @property
    def p999_s(self) -> float:
        return _tail_quantile(self.latency_s, 0.999) \
            if self.latency_s.size else 0.0

    def as_dict(self) -> dict:
        return {
            "scenario": "serving",
            "approach": self.approach,
            "arrival": self.arrival,
            "n_requests": self.n_requests,
            "n_tenants": self.n_tenants,
            "n_stages": self.n_stages,
            "offered_rps": self.offered_rps,
            "goodput_rps": self.goodput_rps,
            "mean_us": (float(self.latency_s.mean()) / US
                        if self.latency_s.size else 0.0),
            "p50_us": self.p50_s / US,
            "p99_us": self.p99_s / US,
            "p999_us": self.p999_s / US,
            "tts_us": self.tts_s / US,
            "n_messages": self.n_messages,
            "n_waves": self.n_waves,
            "n_retransmits": self.n_retransmits,
            "retrans_bytes": self.retrans_bytes,
            "policy": self.policy,
            "n_shed": self.n_shed,
            "n_completed": self.completed,
            "goodput_retention": self.goodput_retention,
            "n_hedges": self.n_hedges,
            "n_suppressed": self.n_suppressed,
            "duplicate_bytes": self.duplicate_bytes,
        }


def simulate_serving(approach: str, *, arrival: str = "poisson",
                     rate_rps: float, n_requests: int, n_tenants: int = 1,
                     skew: float = 0.0, n_stages: int = 4, theta: int,
                     part_bytes: float, n_vcis: int = 1,
                     aggr_bytes: float = 0.0, compute_us: float = 0.0,
                     window_us: float = 5.0, seed: int = 0,
                     faults: Optional[FaultSpec] = None,
                     policy=None, queue_depth: Optional[int] = None,
                     deadline_us: Optional[float] = None,
                     cfg: NetConfig = DEFAULT_NET,
                     engine: str = "cuda",
                     device="cuda") -> ServingResult:
    """Open-loop serving: a request trace drives pipeline-parallel decode
    flows through one schedule on a live fabric.

    Requests arrive on the trace's clock (:func:`repro_torch.core.arrivals
    .make_trace` — Poisson, bursty, or multi-tenant; fully seeded, no
    wall-clock).  Each request is a decode step crossing ``n_stages``
    pipeline stages (ranks): hop k is one flow of the chosen schedule
    from stage k to k+1, ``theta`` partitions of ``part_bytes`` each
    (the per-stage activation split — KV-head/chunk partitions, as the
    JAX package's flash decode splits them), with hop k+1 starting when
    hop k's last partition lands.  ``compute_us`` staggers partition readiness
    linearly across theta (the decode kernel emitting partitions
    progressively), which is what the partitioned path overlaps.

    Admission is in *waves*: every scheduler tick (``window_us``), all
    flows whose start time falls inside the tick are built, merged by a
    stable sort on t_ready (identical tie-breaks to the closed-loop
    merge) and fed to the engines' streaming ``advance`` path — the
    fabric's warm VCI/NIC/wire state carries across waves, so queueing
    from one wave delays the next exactly as in one long scalar run.
    The wave loop, columns and finish arithmetic are engine-independent:
    only ``fab.advance`` differs, which is why the batched engines stay
    bit-for-bit with the reference oracle here too.

    Multi-tenant sharing: tenant i's flows are stamped thread ``tenant``
    (each tenant drives its own progress thread per stage, so tenants
    interleaving on a shared VCI pay the ``chi_switch`` lock bounce of
    §4.2.1) and VCI offset ``+ tenant`` (the per-communicator VCI hash:
    tenants rotate over the VCI bank instead of piling onto VCI 0).
    Dependent-traffic schedules (RMA epochs) run whole at admission
    time, message-by-message on the shared fabric, unstamped.

    Returns per-request latencies (arrival to last-stage delivery) with
    p50/p99/p999 tails and goodput — completion throughput — to plot
    against the offered load.

    ``faults`` (a :class:`repro_torch.core.faults.FaultSpec`) perturbs the
    run: link-degradation windows slow the wire stage, and with
    ``drop_prob > 0`` each wave's messages face seeded per-partition
    drops — dropped messages re-enter the live fabric in deterministic
    retransmission sub-rounds (timeout + exponential backoff) *within*
    the wave, so their queue contention and backoff delay propagate into
    the hop's completion and from there into the latency tail.  Drop
    verdicts draw from ``SeedSequence([faults.seed, wave_index])``, so
    faulty runs are exactly reproducible and engine-independent; a
    no-op spec (no drops, no degradations) leaves every byte of the
    fault-free run unchanged.

    ``policy`` (:mod:`repro_torch.core.recovery`: ``None``/"fixed",
    "adaptive", "hedged" or a
    :class:`~repro_torch.core.recovery.RecoveryPolicy`) sets the
    retransmission clock for dropped messages; estimator state persists
    across waves, so the adaptive RTO and the hedge delay personalize
    to the trace.  The default reproduces the pre-policy fixed timeout
    bit-for-bit.

    Overload protection: ``queue_depth`` caps each tenant's in-flight
    admissions — a request arriving while its tenant already has
    ``queue_depth`` requests in the pipeline is shed at admission
    (completions land at wave granularity, so admission sees the state
    as of the previous wave).  ``deadline_us`` sheds a request at any
    hop boundary once its age exceeds the deadline, freeing the fabric
    mid-pipeline.  Shed requests are excluded from the latency tails
    and counted in ``n_shed``; ``goodput_retention`` reports the
    within-deadline completion fraction, which is what plateaus (rather
    than p99 diverging) when offered-load sweeps pass saturation.
    ``None`` (the default) disables both and leaves the run unchanged.
    """
    if n_stages < 2:
        raise ValueError("n_stages must be at least 2 (one pipeline hop)")
    if queue_depth is not None and queue_depth < 1:
        raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
    if deadline_us is not None and deadline_us <= 0.0:
        raise ValueError(
            f"deadline_us must be positive, got {deadline_us}")
    sched = _lookup(approach)
    trace = make_trace(arrival, rate_rps, n_requests, n_tenants=n_tenants,
                       skew=skew, seed=seed)
    if faults is not None and not faults.is_noop:
        fab = make_faulty_fabric(engine, cfg, n_vcis, n_stages, faults,
                                 device=device)
    else:
        fab = _make_fabric(engine, cfg, n_vcis, n_ranks=n_stages,
                           device=device)
    drops_on = faults is not None and faults.drops_enabled
    pol = make_policy(policy)
    state = pol.fresh(faults.timeout_us, faults.backoff) \
        if drops_on else None
    deadline = deadline_us * US if deadline_us is not None else None
    n_retransmits = 0
    retrans_bytes = 0.0
    n_shed = 0
    ready = np.zeros((1, theta))
    if compute_us > 0.0:
        # partition j ready at (j+1)/theta of the per-hop decode compute
        ready[0] = np.arange(1, theta + 1) * (compute_us * US / theta)
    window = window_us * US
    # (start time, request, hop): the heap key is total, so pop order —
    # and with it every downstream tie-break — is deterministic.
    pending: List[Tuple[float, int, int]] = [
        (float(t), r, 0) for r, t in enumerate(trace.t)]
    heapq.heapify(pending)
    done = np.zeros(len(trace))
    # overload protection state: exited[r] > 0 once r left the system
    # (completed or shed mid-pipeline); per-tenant admission lists are
    # pruned as the heap's monotone pop order advances the clock
    exited = np.zeros(len(trace))
    shed = np.zeros(len(trace), dtype=bool)
    tenant_live: List[List[int]] = [[] for _ in range(n_tenants)]
    n_waves = 0
    while pending:
        horizon = pending[0][0] + window
        wave = []
        while pending and pending[0][0] <= horizon:
            wave.append(heapq.heappop(pending))
        n_waves += 1
        flows: List[Scenario] = []
        entries: List[Tuple[int, int]] = []
        cols = []
        completions: List[Tuple[int, int, float]] = []
        for t_start, req, hop in wave:
            if deadline is not None \
                    and t_start - trace.t[req] > deadline:
                # past its deadline mid-pipeline: shed now, free the
                # fabric of the remaining hops
                shed[req] = True
                n_shed += 1
                exited[req] = t_start
                continue
            if hop == 0 and queue_depth is not None:
                ten = int(trace.tenant[req])
                live = [r for r in tenant_live[ten]
                        if exited[r] == 0.0 or exited[r] > t_start]
                tenant_live[ten] = live
                if len(live) >= queue_depth:
                    shed[req] = True
                    n_shed += 1
                    continue
                live.append(req)
            sc = Scenario(n_threads=1, theta=theta, part_bytes=part_bytes,
                          ready=ready, n_vcis=n_vcis, aggr_bytes=aggr_bytes,
                          cfg=cfg, src=hop, dst=hop + 1, t0=t_start)
            batch = sched.intent_batch(sc)
            if batch is None:  # dependent traffic: runs whole, scalar path
                completions.append((req, hop, sched.run(sc, fab)))
                continue
            tenant = int(trace.tenant[req])
            flows.append(sc)
            entries.append((req, hop))
            cols.append((batch.t_ready, batch.nbytes, batch.vci + tenant,
                         batch.thread + tenant, batch.put, batch.am_copy))
        if flows:
            lens = np.array([c[0].shape[0] for c in cols], dtype=np.int64)
            srcs = np.array([sc.src for sc in flows], dtype=np.int64)
            dsts = np.array([sc.dst for sc in flows], dtype=np.int64)
            t_ready = np.concatenate([c[0] for c in cols])
            mnb = np.concatenate([c[1] for c in cols])
            mvci = np.concatenate([c[2] for c in cols])
            mth = np.concatenate([c[3] for c in cols])
            mput = np.concatenate([c[4] for c in cols])
            mcopy = np.concatenate([c[5] for c in cols])
            msrc = np.repeat(srcs, lens)
            mdst = np.repeat(dsts, lens)
            if not drops_on:
                order = np.argsort(t_ready, kind="stable")
                arr = fab.advance(t_ready[order], mnb[order], mvci[order],
                                  mth[order], mput[order], mcopy[order],
                                  msrc[order], mdst[order])
                arrivals = np.empty_like(arr)
                arrivals[order] = arr
            else:
                # Retransmission sub-rounds within the wave: verdicts
                # are a pure function of (flow-major message id, attempt)
                # under this wave's seeded draws, so the loop is
                # engine-independent; each re-entry pays real contention
                # on the warm fabric plus the backoff delay.
                p_msg = faults.message_drop_prob(np.rint(mnb / part_bytes))
                draws = DropDraws(faults, t_ready.shape[0],
                                  extra=(n_waves,))
                arrivals = np.empty_like(t_ready)
                t_cur = t_ready.copy()
                pend = np.arange(t_ready.shape[0])
                attempt = 0
                while pend.size:
                    order = np.argsort(t_cur[pend], kind="stable")
                    sel = pend[order]
                    t_sub = t_cur[sel]
                    arr = fab.advance(t_sub, mnb[sel], mvci[sel],
                                      mth[sel], mput[sel], mcopy[sel],
                                      msrc[sel], mdst[sel])
                    drop = draws.dropped(sel, attempt, p_msg[sel])
                    state.observe(msrc[sel], mdst[sel], t_sub, arr,
                                  mnb[sel], attempt, ~drop)
                    arrivals[sel[~drop]] = arr[~drop]
                    if drop.any():
                        t_cur[sel[drop]] = state.retrans_times(
                            msrc[sel[drop]], mdst[sel[drop]],
                            t_sub[drop], arr[drop], attempt)
                        n_retransmits += int(drop.sum())
                        retrans_bytes += float(mnb[sel[drop]].sum())
                    pend = np.sort(sel[drop])
                    attempt += 1
            finished, _ = _finish_flows(sched, fab, flows, lens, arrivals)
            completions.extend(
                (req, hop, t)
                for (req, hop), t in zip(entries, finished.tolist()))
        for req, hop, t in completions:
            if hop + 1 < n_stages - 1:
                heapq.heappush(pending, (float(t), req, hop + 1))
            else:
                done[req] = t
                exited[req] = t
    completed = done > 0.0
    latency = done[completed] - trace.t[completed]
    n_completed = int(np.count_nonzero(completed))
    n_good = n_completed if deadline is None \
        else int(np.count_nonzero(latency <= deadline))
    return ServingResult(approach=approach, arrival=arrival,
                         n_requests=len(trace), n_tenants=n_tenants,
                         n_stages=n_stages,
                         offered_rps=trace.offered_rps,
                         latency_s=latency, tts_s=float(done.max()),
                         n_messages=fab.n_messages, n_waves=n_waves,
                         n_retransmits=n_retransmits,
                         retrans_bytes=retrans_bytes,
                         policy=pol.kind, n_shed=n_shed,
                         n_completed=n_completed, n_good=n_good,
                         n_hedges=state.n_hedges if state else 0,
                         n_suppressed=state.n_suppressed if state else 0,
                         duplicate_bytes=state.duplicate_bytes
                         if state else 0.0)


@dataclass
class FaultyResult:
    """Stencil exchange under seeded fault injection: dropped partitions
    retransmitted through the live queues, degraded links, and the
    recovery delta against the same scenario on a healthy fabric."""
    approach: str
    dims: tuple
    periodic: tuple
    face_bytes: tuple
    drop_prob: float
    seed: int
    rank_tts_s: List[float]    # per-rank completion (all faces delivered)
    time_s: float              # max completion minus compute
    tts_s: float
    clean_tts_s: float         # same scenario, fault-free fabric
    n_messages: int            # wire messages incl. retransmissions
    n_delivered: int           # planned messages (each delivered once)
    n_retransmits: int
    retrans_bytes: float
    rounds: int                # retransmission rounds until drained
    goodput_bps: float         # delivered payload bytes / tts
    clean_goodput_bps: float
    policy: str = "fixed"      # recovery policy (core/recovery.py)
    n_hedges: int = 0          # hedge timers fired (hedged policy)
    n_suppressed: int = 0      # duplicate deliveries suppressed
    duplicate_bytes: float = 0.0  # wasted payload of suppressed hedges
    # per-message clocks of the drops path (None elsewhere): original
    # submission and final delivery, for the chaos harness's monotone
    # and conservation invariants
    submit_s: Optional[np.ndarray] = None
    arrival_s: Optional[np.ndarray] = None

    @property
    def recovery_s(self) -> float:
        """Fault-induced completion inflation: tts minus the clean tts."""
        return self.tts_s - self.clean_tts_s

    @property
    def time_us(self) -> float:
        return self.time_s / US

    def as_dict(self) -> dict:
        return {
            "scenario": "faulty",
            "approach": self.approach,
            "dims": list(self.dims),
            "periodic": list(self.periodic),
            "face_bytes": list(self.face_bytes),
            "drop_prob": self.drop_prob,
            "seed": self.seed,
            "time_us": self.time_us,
            "tts_us": self.tts_s / US,
            "clean_tts_us": self.clean_tts_s / US,
            "recovery_us": self.recovery_s / US,
            "n_messages": self.n_messages,
            "n_delivered": self.n_delivered,
            "n_retransmits": self.n_retransmits,
            "retrans_bytes": self.retrans_bytes,
            "rounds": self.rounds,
            "goodput_gbps": self.goodput_bps / 1e9,
            "clean_goodput_gbps": self.clean_goodput_bps / 1e9,
            "policy": self.policy,
            "n_hedges": self.n_hedges,
            "n_suppressed": self.n_suppressed,
            "duplicate_bytes": self.duplicate_bytes,
        }


def simulate_faulty(approach: str, *, faults: Optional[FaultSpec],
                    dims: Sequence[int] = (),
                    topo: Optional[CartTopology] = None, periodic=True,
                    theta: int, n_threads: int = 1,
                    local_shape: Optional[Sequence[int]] = None,
                    bytes_per_cell: float = 8.0, halo_width: int = 1,
                    face_bytes: Optional[Sequence[float]] = None,
                    ready=None, n_vcis: int = 1, aggr_bytes: float = 0.0,
                    policy=None, cfg: NetConfig = DEFAULT_NET,
                    engine: str = "cuda", device="cuda") -> FaultyResult:
    """The stencil exchange of :func:`simulate_stencil` on a faulty
    fabric (:mod:`repro_torch.core.faults`).

    A message carrying k partitions is dropped with probability
    ``1 - (1 - drop_prob) ** k`` — whole-message retransmit, so the
    pt2pt_single bulk message (k = every partition) is both near-certain
    to drop and maximally expensive to resend, while the partitioned
    path retransmits only the lost chunks.  Dropped messages re-enter
    the live VCI/NIC/wire queues after ``timeout_us * backoff**attempt``
    (measured from the would-be delivery: the sender's ack timeout),
    paying real queue contention against the next round's traffic; the
    attempt at ``max_retries`` always succeeds, bounding the run.  Drop
    verdicts are pre-drawn per (message, attempt) from the spec's
    ``SeedSequence``, so a run is exactly reproducible and the reference
    and vector engines stay bit-for-bit.

    Engine handling: a **no-op spec** (no drops, no degradations)
    delegates straight to :func:`simulate_stencil` on the requested
    engine — bit-for-bit identical to the fault-free scenario on all
    four engines by construction.  With active faults the torch/cuda
    engines run on the batched NumPy fabric, as the reference's
    compiled engines do (retransmission re-entry is data-dependent,
    which defeats their whole-batch layouts); the result is identical
    to ``engine="vector"``.

    Schedules with dependent traffic (the RMA epochs) cannot be
    partition-dropped — their sync messages chain on earlier arrivals —
    so ``drop_prob > 0`` rejects them; degradation-only specs run every
    schedule.  ``recovery_s``/``goodput_bps`` compare against the same
    scenario on a healthy fabric.

    ``policy`` (:mod:`repro_torch.core.recovery`) sets the retransmission
    clock: ``None``/"fixed" is the timeout-and-backoff above, exactly;
    "adaptive" estimates a per-link RTO from the round's own observed
    completions (Jacobson EWMA, Karn's rule); "hedged" re-enters
    dropped messages at a quantile hedge delay from *submission* and
    accounts the suppressed duplicates of slow deliveries.  Drop
    verdicts are (message, attempt)-pure, so the policy changes only
    the clocks — delivered/dropped sets, retransmit counts and round
    structure are policy-invariant here.
    """
    if faults is None:
        faults = FaultSpec()
    pol = make_policy(policy)
    topo, face_bytes, sched, shared_ready, ready_arr = _stencil_setup(
        approach, dims=dims, topo=topo, periodic=periodic, theta=theta,
        n_threads=n_threads, local_shape=local_shape,
        bytes_per_cell=bytes_per_cell, halo_width=halo_width,
        face_bytes=face_bytes, ready=ready)
    srcs, dsts, fdims = topo.flow_arrays()
    payload = float(sum(face_bytes[d] for d in fdims.tolist()))
    if faults.is_noop:
        r = simulate_stencil(approach, topo=topo, theta=theta,
                             n_threads=n_threads, face_bytes=face_bytes,
                             ready=ready, n_vcis=n_vcis,
                             aggr_bytes=aggr_bytes, cfg=cfg, engine=engine,
                             device=device)
        goodput = payload / r.tts_s if r.tts_s > 0.0 else 0.0
        return FaultyResult(
            approach=approach, dims=r.dims, periodic=r.periodic,
            face_bytes=r.face_bytes, drop_prob=faults.drop_prob,
            seed=faults.seed, rank_tts_s=r.rank_tts_s, time_s=r.time_s,
            tts_s=r.tts_s, clean_tts_s=r.tts_s, n_messages=r.n_messages,
            n_delivered=r.n_messages, n_retransmits=0, retrans_bytes=0.0,
            rounds=1, goodput_bps=goodput, clean_goodput_bps=goodput,
            policy=pol.kind)
    clean = simulate_stencil(
        approach, topo=topo, theta=theta, n_threads=n_threads,
        face_bytes=face_bytes, ready=ready, n_vcis=n_vcis,
        aggr_bytes=aggr_bytes, cfg=cfg,
        engine="reference" if engine == "reference" else "vector",
        device=device)
    fab = make_faulty_fabric(engine, cfg, n_vcis, topo.n_ranks, faults,
                             device=device)
    compute = float(ready_arr.max())
    n_part = n_threads * theta
    dim_bytes = [face_bytes[d] / n_part for d in range(topo.n_dims)]
    scenarios = [Scenario(n_threads=n_threads, theta=theta,
                          part_bytes=dim_bytes[d], ready=ready_arr[s],
                          n_vcis=n_vcis, aggr_bytes=aggr_bytes, cfg=cfg,
                          src=int(s), dst=int(t),
                          class_key=(d,) if shared_ready else (d, int(s)))
                 for s, t, d in zip(srcs, dsts, fdims)]
    if not faults.drops_enabled:
        # degradation-only: one pass through the faulty fabric — the
        # generic multi-flow merge handles dependent traffic too
        incoming = _run_flows(sched, fab, scenarios)
        rank_tts = [max(arr) if arr else 0.0 for arr in incoming]
        tts = max(rank_tts)
        return FaultyResult(
            approach=approach, dims=topo.dims, periodic=topo.periodic,
            face_bytes=tuple(face_bytes), drop_prob=faults.drop_prob,
            seed=faults.seed, rank_tts_s=rank_tts,
            time_s=tts - compute, tts_s=tts, clean_tts_s=clean.tts_s,
            n_messages=fab.n_messages, n_delivered=fab.n_messages,
            n_retransmits=0, retrans_bytes=0.0, rounds=1,
            goodput_bps=payload / tts if tts > 0.0 else 0.0,
            clean_goodput_bps=payload / clean.tts_s
            if clean.tts_s > 0.0 else 0.0, policy=pol.kind)
    flows: List[Scenario] = []
    batches: List[IntentBatch] = []
    memo: Dict[tuple, Optional[IntentBatch]] = {}
    for sc in scenarios:
        key = _scenario_class_key(sc)
        if key not in memo:
            memo[key] = sched.intent_batch(sc)
        batch = memo[key]
        if batch is None:
            raise ValueError(
                f"partition drops need pipelinable traffic; approach "
                f"{approach!r} plans dependent traffic (RMA epochs) — "
                f"use a degradation-only FaultSpec or a pipelinable "
                f"approach")
        flows.append(sc)
        batches.append(batch)
    lens = np.array([len(b) for b in batches], dtype=np.int64)
    t_ready = np.concatenate([b.t_ready for b in batches])
    nbytes = np.concatenate([b.nbytes for b in batches])
    vci = np.concatenate([b.vci for b in batches])
    thread = np.concatenate([b.thread for b in batches])
    put = np.concatenate([b.put for b in batches])
    am_copy = np.concatenate([b.am_copy for b in batches])
    src_col = np.repeat(srcs, lens)
    dst_col = np.repeat(dsts, lens)
    flow_pb = np.array([sc.part_bytes for sc in flows])
    # partitions per message: plans aggregate whole partitions, so the
    # ratio is integral up to fp wobble; 0-byte syncs round to 0 (immune)
    pcount = np.rint(nbytes / np.repeat(flow_pb, lens))
    p_msg = faults.message_drop_prob(pcount)
    n = int(t_ready.shape[0])
    draws = DropDraws(faults, n)
    state = pol.fresh(faults.timeout_us, faults.backoff)
    final = np.empty(n)
    t_cur = t_ready.copy()
    pend = np.arange(n)
    attempt = 0
    rounds = 0
    n_retransmits = 0
    retrans_bytes = 0.0
    while pend.size:
        rounds += 1
        order = np.argsort(t_cur[pend], kind="stable")
        sel = pend[order]
        t_sub = t_cur[sel]
        arr = fab.advance(t_sub, nbytes[sel], vci[sel], thread[sel],
                          put[sel], am_copy[sel], src_col[sel],
                          dst_col[sel])
        drop = draws.dropped(sel, attempt, p_msg[sel])
        state.observe(src_col[sel], dst_col[sel], t_sub, arr,
                      nbytes[sel], attempt, ~drop)
        final[sel[~drop]] = arr[~drop]
        if drop.any():
            t_cur[sel[drop]] = state.retrans_times(
                src_col[sel[drop]], dst_col[sel[drop]], t_sub[drop],
                arr[drop], attempt)
            n_retransmits += int(drop.sum())
            retrans_bytes += float(nbytes[sel[drop]].sum())
        pend = np.sort(sel[drop])
        attempt += 1
    finished, _ = _finish_flows(sched, fab, flows, lens, final)
    rank_arr = np.zeros(topo.n_ranks)
    np.maximum.at(rank_arr, dsts, finished)
    rank_tts = rank_arr.tolist()
    tts = max(rank_tts)
    return FaultyResult(
        approach=approach, dims=topo.dims, periodic=topo.periodic,
        face_bytes=tuple(face_bytes), drop_prob=faults.drop_prob,
        seed=faults.seed, rank_tts_s=rank_tts, time_s=tts - compute,
        tts_s=tts, clean_tts_s=clean.tts_s, n_messages=fab.n_messages,
        n_delivered=n, n_retransmits=n_retransmits,
        retrans_bytes=retrans_bytes, rounds=rounds,
        goodput_bps=payload / tts if tts > 0.0 else 0.0,
        clean_goodput_bps=payload / clean.tts_s
        if clean.tts_s > 0.0 else 0.0,
        policy=pol.kind, n_hedges=state.n_hedges,
        n_suppressed=state.n_suppressed,
        duplicate_bytes=state.duplicate_bytes,
        submit_s=t_ready, arrival_s=final)


@dataclass
class MembershipResult:
    """Steady-state ring exchange with elastic rank membership: leave /
    join events trigger CommPlan re-agreement over the surviving grid,
    and the quiesce + re-plan + warm-up cost is measured in-band."""
    approach: str
    n_ranks: int               # initial communicator size
    n_iters: int
    n_events: int              # membership events actually processed
    iter_times_s: List[float]  # per-iteration time minus compute
    epoch_starts: List[int]    # iteration index opening each epoch
    quiesce_s: float           # failure detection + drain barriers
    replan_s: float            # plan_mesh + request rebuild + agreement
    warmup_s: float            # first post-event iter minus settled iter
    tts_s: float
    n_messages: int
    plan_data: int             # final ElasticPlan.data
    plan_model: int
    plan_dropped: int          # final ElasticPlan.dropped_devices
    grad_accum_factor: int

    @property
    def reagree_s(self) -> float:
        """Total re-agreement cost consumed by membership changes."""
        return self.quiesce_s + self.replan_s

    @property
    def steady_iter_s(self) -> float:
        """Settled per-iteration time of the first epoch (the iteration
        just before the first membership event; the last iteration when
        no event fired)."""
        if self.n_events and len(self.epoch_starts) > 1:
            return self.iter_times_s[max(0, self.epoch_starts[1] - 1)]
        return self.iter_times_s[-1]

    @property
    def post_iter_s(self) -> float:
        """Settled per-iteration time after the last event."""
        return self.iter_times_s[-1]

    def as_dict(self) -> dict:
        return {
            "scenario": "membership",
            "approach": self.approach,
            "n_ranks": self.n_ranks,
            "n_iters": self.n_iters,
            "n_events": self.n_events,
            "iter_times_us": [t / US for t in self.iter_times_s],
            "epoch_starts": list(self.epoch_starts),
            "quiesce_us": self.quiesce_s / US,
            "replan_us": self.replan_s / US,
            "reagree_us": self.reagree_s / US,
            "warmup_us": self.warmup_s / US,
            "steady_iter_us": self.steady_iter_s / US,
            "post_iter_us": self.post_iter_s / US,
            "tts_us": self.tts_s / US,
            "n_messages": self.n_messages,
            "plan_data": self.plan_data,
            "plan_model": self.plan_model,
            "plan_dropped": self.plan_dropped,
            "grad_accum_factor": self.grad_accum_factor,
        }


def simulate_membership(approach: str, *, n_ranks: int, theta: int,
                        part_bytes: float, faults: Optional[FaultSpec],
                        n_iters: int, n_threads: int = 1, n_vcis: int = 1,
                        aggr_bytes: float = 0.0, model_parallel: int = 1,
                        target_data: Optional[int] = None,
                        detect_us: float = 100.0, periodic: bool = True,
                        ready=None, cfg: NetConfig = DEFAULT_NET,
                        engine: str = "cuda",
                        device="cuda") -> MembershipResult:
    """Elastic membership: a steady-state ring exchange whose communicator
    shrinks/grows mid-run on the spec's :class:`RankFailure` events.

    Iterations run back-to-back like :func:`simulate_steady_state` (warm
    fabric, chained epochs).  At each iteration boundary, due events
    fire: the survivor count changes, the old grid quiesces (``detect_us``
    failure detection plus a drain barrier), a new mesh is planned with
    ``runtime.elastic.plan_mesh`` (model-parallel degree fixed, data
    degree absorbs the loss; ``target_data`` keeps the global batch via
    gradient accumulation), and the CommPlan is re-agreed over the new
    grid — persistent-request rebuild (``alpha_init`` +
    ``alpha_init_msg`` per planned request) plus a log-depth agreement
    round.  The next epoch starts on a *cold* fabric of the new size, so
    the first post-event iteration's warm-up is measured, not assumed.
    Every cost lands on the run's clock: ``tts_s`` includes the
    re-agreement stall, and ``reagree_s``/``warmup_s`` break it out.

    The driver is deterministic (events are declared, nothing is drawn)
    and engine-independent by the engines' bit-for-bit contract; drop /
    degradation entries of the spec are ignored here — the fabric within
    an epoch is healthy (combine with :func:`simulate_faulty` to study
    both at once).
    """
    from ..runtime.elastic import plan_mesh  # lazy: runtime layer
    if n_iters <= 0:
        raise ValueError("n_iters must be positive")
    if n_ranks < 2:
        raise ValueError("membership ring needs at least 2 ranks")
    if faults is None:
        faults = FaultSpec()
    sched = _lookup(approach)
    ready_arr = _normalize_ready(n_threads, theta, ready)
    compute = float(ready_arr.max())
    events = []
    for f in faults.failures:
        events.append((f.t_fail_us * US, "leave", f.rank))
        if f.t_recover_us is not None:
            events.append((f.t_recover_us * US, "join", f.rank))
    events.sort(key=lambda e: e[0])

    def _setup_cost(n_comm: int) -> float:
        # per-rank persistent requests for both neighbor flows, then one
        # allreduce-style CommPlan agreement over the new communicator
        template = Scenario(n_threads=n_threads, theta=theta,
                            part_bytes=part_bytes, ready=ready_arr,
                            n_vcis=n_vcis, aggr_bytes=aggr_bytes, cfg=cfg)
        n_req = 2 * sched.n_requests(template)
        agree = 2.0 * cfg.alpha_wire * math.ceil(math.log2(n_comm))
        return (cfg.alpha_init + cfg.alpha_init_msg * n_req
                + cfg.barrier(n_comm) + agree)

    n_live = n_ranks
    plan = plan_mesh(n_live, model_parallel, target_data=target_data)
    if plan.n_devices < 2:
        raise ValueError(
            f"plan over {n_live} devices uses {plan.n_devices}; the ring "
            f"needs at least 2")
    fab = _make_fabric(engine, cfg, n_vcis, n_ranks=plan.n_devices,
                       device=device)
    t = _setup_cost(plan.n_devices)
    quiesce = 0.0
    replan = 0.0
    iter_times: List[float] = []
    epoch_starts = [0]
    n_messages = 0
    ev = 0
    for it in range(n_iters):
        while ev < len(events) and events[ev][0] <= t:
            _, kind, _rank = events[ev]
            ev += 1
            n_live = n_live - 1 if kind == "leave" \
                else min(n_ranks, n_live + 1)
            if n_live < max(2, model_parallel):
                raise ValueError(
                    f"membership event leaves {n_live} device(s); need "
                    f"at least {max(2, model_parallel)}")
            q = detect_us * US + cfg.barrier(plan.n_devices)
            plan = plan_mesh(n_live, model_parallel,
                             target_data=target_data)
            r_cost = _setup_cost(plan.n_devices)
            quiesce += q
            replan += r_cost
            t += q + r_cost
            n_messages += fab.n_messages
            # cold fabric of the new size: the next iteration pays real
            # warm-up (idle VCIs, empty wires) instead of a modeled one
            fab = _make_fabric(engine, cfg, n_vcis,
                               n_ranks=plan.n_devices, device=device)
            epoch_starts.append(it)
        topo = CartTopology.create((plan.n_devices,), periodic)
        srcs, dsts, _fdims = topo.flow_arrays()
        scenarios = [Scenario(n_threads=n_threads, theta=theta,
                              part_bytes=part_bytes, ready=ready_arr,
                              n_vcis=n_vcis, aggr_bytes=aggr_bytes,
                              cfg=cfg, src=int(s), dst=int(d), t0=t,
                              class_key=(0,))
                     for s, d in zip(srcs, dsts)]
        incoming = _run_flows(sched, fab, scenarios)
        tts = max(max(arr) if arr else 0.0 for arr in incoming)
        iter_times.append(tts - t - compute)
        t = tts
    n_messages += fab.n_messages
    if len(epoch_starts) > 1 and epoch_starts[-1] < n_iters:
        warmup = iter_times[epoch_starts[-1]] - iter_times[-1]
    else:
        warmup = 0.0
    return MembershipResult(
        approach=approach, n_ranks=n_ranks, n_iters=n_iters, n_events=ev,
        iter_times_s=iter_times, epoch_starts=epoch_starts,
        quiesce_s=quiesce, replan_s=replan, warmup_s=warmup, tts_s=t,
        n_messages=n_messages, plan_data=plan.data, plan_model=plan.model,
        plan_dropped=plan.dropped_devices,
        grad_accum_factor=plan.grad_accum_factor)


def sweep_sizes(approach: str, sizes: Sequence[int], **kw) -> Dict[int, SimResult]:
    """Run ``simulate`` across total-buffer sizes (bytes)."""
    out = {}
    n_part = kw["n_threads"] * kw["theta"]
    for s in sizes:
        out[s] = simulate(approach, part_bytes=s / n_part,
                          **{k: v for k, v in kw.items() if k != "part_bytes"})
    return out


def delayed_ready(n_threads: int, theta: int, part_bytes: float,
                  gamma_us_per_mb: float) -> np.ndarray:
    """Fig-8 scenario: the last partition is delayed by gamma * S_part."""
    ready = np.zeros((n_threads, theta))
    ready[-1, -1] = gamma_us_per_mb * 1e-12 * part_bytes
    return ready


def sampled_ready(workload, n_threads: int, theta: int, part_bytes: float,
                  seed: int = 0) -> np.ndarray:
    """Appendix-A scenario: per-partition compute time mu*S*N(1, sigma),
    accumulated sequentially on each thread.  The sampling itself lives on
    :class:`~repro_torch.core.perfmodel.Workload` (the model owns its
    noise)."""
    rng = np.random.default_rng(seed)
    return workload.sample_ready(n_threads, theta, part_bytes, rng)


def theoretical_time(total_bytes: float, cfg: NetConfig = DEFAULT_NET) -> float:
    """The 'theoretical bandwidth' reference line of Fig 4."""
    return total_bytes / cfg.beta
