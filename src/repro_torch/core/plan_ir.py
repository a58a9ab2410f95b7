"""CommPlan IR: a declarative multi-flow plan representation with
cross-flow optimization passes.

The port's copy of the JAX package's ``core/plan_ir.py``: the same ops,
raisers, passes and text form, lowered to the same intent columns and
executed on the port's fabric engines (``engine="cuda"`` and
``device="cuda"`` by default; ``torch``, ``vector`` and ``reference``
too).  A module and every rewrite of it equal the reference's, and its
execution equals the reference's bit for bit in float64.

``plan_auto`` (:mod:`repro_torch.core.commplan`) optimizes each flow
*pointwise*: the model picks (theta, aggr_bytes, n_vcis) for one flow in
isolation, and the round-robin channel map restarts at VCI 0 for every
flow.  Cross-flow structure — two stencil faces sharing a (src, dst)
link, many small flows queueing ahead of one NIC, a rank's VCI bank
shared by all of its outgoing flows — has no place to live in a single
:class:`~repro_torch.core.commplan.CommPlan`.  This module lifts a whole
multi-flow scenario into a small SSA-flavoured IR (xdsl-style op
modelling: one immutable op per fact, a module owning the op stream)
and rewrites it with a guarded :class:`PassPipeline`:

  * :class:`FlowOp` — one flow: ``n_threads`` producer threads x
    ``theta`` partitions of ``part_bytes`` from ``src`` to ``dst``,
    starting at ``t0`` with the ready table ``ready_class``;
  * :class:`PartitionMapOp` — the flow's partition -> wire-message
    aggregation (explicit groups + payloads, losslessly round-tripping
    the flow's :class:`~repro_torch.core.commplan.CommPlan`);
  * :class:`ChannelAssignOp` — the flow's message -> VCI map;
  * :class:`BarrierOp` — the thread barrier closing the flow's
    ``MPI_Wait`` (raised for the partitioned schedule, whose ``finish``
    pays ``cfg.barrier(n_threads)``).

Raising (``raise_scenarios`` / ``raise_stencil`` / ``raise_serving_wave``)
lowers today's ``commplan.make_plan``-style scenarios into IR;
:func:`execute` lowers a module back to ordinary intent columns and runs
them through any of the four fabric engines *unchanged* — a freshly
raised module reproduces
:func:`repro_torch.core.simulator.simulate_stencil` bit-for-bit.

The passes:

  * ``canonicalize`` — identity-eligible normalization (op ordering,
    channel range reduction, duplicate-barrier removal); lowered
    columns are bit-for-bit unchanged;
  * ``fuse-faces`` — merge flows sharing a (src, dst) link and plan
    shape (adjacent stencil faces of one dimension) into one flow, and
    aggregate across the former face boundary under the flows' bound;
  * ``merge-small-flows`` — coalesce sub-aggregation-bound wire
    messages ahead of the NIC (contiguous re-grouping under a bound,
    default the bcopy/rendezvous switch);
  * ``global-channels`` — reassign VCIs round-robin across *all* flows
    of a rank instead of restarting per flow.

Optimizing passes are *measured*: :meth:`PassPipeline.run` simulates
every rewrite and keeps it only when the total time does not increase,
so the pipeline never hands back a module slower than its input — the
"pipeline <= pointwise" property of the ``ir_passes`` sweep records
holds by construction, and silent miscompiles are caught by the
equivalence suite rather than shipped as speedups.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from . import simulator as sim
from .arrivals import make_trace
from .commplan import CommPlan, WireMessage
from .fabric import DEFAULT_NET, US, NetConfig
from .fabric_torch import resolve_device
from .faults import DropDraws, FaultSpec, make_faulty_fabric
from .simulator import SCHEDULES, Scenario

__all__ = [
    "FlowOp", "PartitionMapOp", "ChannelAssignOp", "BarrierOp", "Module",
    "raise_scenarios", "raise_stencil", "raise_serving_wave",
    "module_from_plan", "plan_of", "IRResult", "execute",
    "Canonicalize", "FuseFaces", "MergeSmallFlows", "GlobalChannels",
    "PassPipeline", "PASSES", "default_pipeline", "optimize_plan",
]

# Schedules the executor can lower: their traffic is declarative intent
# columns.  Dependent-traffic schedules (RMA epochs) can still be raised
# for plan round-tripping, but not executed through the IR path.
PIPELINED = ("part", "part_old", "pt2pt_single", "pt2pt_many")


# --------------------------------------------------------------------------
# Ops


@dataclass(frozen=True)
class FlowOp:
    """One flow: n_threads x theta partitions of part_bytes, src -> dst.

    ``ready_class`` indexes :attr:`Module.ready_tables`; ``aggr_bytes``
    records the aggregation bound the flow's partition map was planned
    under (metadata the fuse pass merges across face boundaries with);
    ``tenant`` offsets the flow's VCIs and threads (the serving driver's
    multi-tenant stamping).
    """
    src: int
    dst: int
    n_threads: int
    theta: int
    part_bytes: float
    ready_class: int
    t0: float = 0.0
    aggr_bytes: float = 0.0
    tenant: int = 0

    @property
    def n_part(self) -> int:
        return self.n_threads * self.theta

    @property
    def total_bytes(self) -> float:
        return self.n_part * self.part_bytes


@dataclass(frozen=True)
class PartitionMapOp:
    """Partition -> wire-message aggregation of flow ``flow``: one
    partition-id tuple and one payload size per wire message, in
    injection order."""
    flow: int
    groups: Tuple[Tuple[int, ...], ...]
    nbytes: Tuple[float, ...]


@dataclass(frozen=True)
class ChannelAssignOp:
    """Wire-message -> VCI map of flow ``flow`` (pre-modulo, like
    IntentBatch's vci column — the fabric reduces mod its VCI count)."""
    flow: int
    channels: Tuple[int, ...]


@dataclass(frozen=True)
class BarrierOp:
    """The thread barrier closing flow ``flow``'s MPI_Wait (partitioned
    schedule only; its cost is ``cfg.barrier(n_threads)``)."""
    flow: int
    n_threads: int


@dataclass(eq=False)
class Module:
    """One multi-flow scenario as an op stream.

    Flows are numbered by order of appearance of their :class:`FlowOp`
    in ``ops``; that order is the flow-major merge order of
    :func:`execute` (identical to the drivers' enumeration order, which
    is what makes a freshly raised module bit-for-bit with them).
    """
    approach: str
    n_ranks: int
    n_vcis: int
    cfg: NetConfig = DEFAULT_NET
    ready_tables: Tuple[np.ndarray, ...] = ()
    ops: Tuple[object, ...] = ()

    def flows(self) -> List[FlowOp]:
        return [op for op in self.ops if isinstance(op, FlowOp)]

    def _by_flow(self, kind) -> Dict[int, object]:
        out: Dict[int, object] = {}
        for op in self.ops:
            if isinstance(op, kind):
                if op.flow in out:
                    raise ValueError(
                        f"flow {op.flow} has more than one"
                        f" {kind.__name__}")
                out[op.flow] = op
        return out

    def partition_maps(self) -> Dict[int, PartitionMapOp]:
        return self._by_flow(PartitionMapOp)

    def channel_assigns(self) -> Dict[int, ChannelAssignOp]:
        return self._by_flow(ChannelAssignOp)

    def barriers(self) -> Dict[int, BarrierOp]:
        out: Dict[int, BarrierOp] = {}
        for op in self.ops:
            if isinstance(op, BarrierOp):
                out[op.flow] = op  # duplicates allowed; canonicalize drops
        return out

    def validate(self) -> None:
        """Structural invariants; raises ValueError on violation."""
        if self.approach not in SCHEDULES:
            raise ValueError(f"unknown approach {self.approach!r}")
        flows = self.flows()
        pmaps = self.partition_maps()
        chans = self.channel_assigns()
        for fid, fop in enumerate(flows):
            if not (0 <= fop.src < self.n_ranks
                    and 0 <= fop.dst < self.n_ranks):
                raise ValueError(f"flow {fid}: endpoints outside"
                                 f" {self.n_ranks}-rank module")
            if not 0 <= fop.ready_class < len(self.ready_tables):
                raise ValueError(f"flow {fid}: ready_class"
                                 f" {fop.ready_class} unbound")
            tbl = self.ready_tables[fop.ready_class]
            if tbl.shape != (fop.n_threads, fop.theta):
                raise ValueError(
                    f"flow {fid}: ready table shape {tbl.shape} !="
                    f" ({fop.n_threads}, {fop.theta})")
            pm = pmaps.get(fid)
            ch = chans.get(fid)
            if pm is None or ch is None:
                raise ValueError(f"flow {fid}: missing partition map"
                                 f" or channel assignment")
            covered = sorted(p for g in pm.groups for p in g)
            if covered != list(range(fop.n_part)):
                raise ValueError(f"flow {fid}: partition map does not"
                                 f" cover 0..{fop.n_part - 1} exactly"
                                 f" once")
            if len(pm.nbytes) != len(pm.groups):
                raise ValueError(f"flow {fid}: {len(pm.nbytes)} payload"
                                 f" sizes for {len(pm.groups)} groups")
            if len(ch.channels) != len(pm.groups):
                raise ValueError(f"flow {fid}: {len(ch.channels)}"
                                 f" channels for {len(pm.groups)}"
                                 f" messages")
        for op in self.ops:
            if isinstance(op, (PartitionMapOp, ChannelAssignOp,
                               BarrierOp)) and not (
                    0 <= op.flow < len(flows)):
                raise ValueError(f"op references unknown flow {op.flow}")

    @property
    def n_wire(self) -> int:
        """Planned wire messages across all flows."""
        return sum(len(pm.groups) for pm in self.partition_maps().values())

    def __str__(self) -> str:
        lines = [f"module(approach = {self.approach!r},"
                 f" ranks = {self.n_ranks}, vcis = {self.n_vcis}) {{"]
        fid = -1
        for op in self.ops:
            if isinstance(op, FlowOp):
                fid += 1
                lines.append(
                    f"  %f{fid} = flow(src = {op.src}, dst = {op.dst},"
                    f" threads = {op.n_threads}, theta = {op.theta},"
                    f" part_bytes = {op.part_bytes:g},"
                    f" ready = @r{op.ready_class}, t0 = {op.t0:g})")
            elif isinstance(op, PartitionMapOp):
                gs = ", ".join("[" + ", ".join(map(str, g)) + "]"
                               for g in op.groups)
                lines.append(f"  partition_map(%f{op.flow},"
                             f" groups = [{gs}])")
            elif isinstance(op, ChannelAssignOp):
                cs = ", ".join(map(str, op.channels))
                lines.append(f"  channel_assign(%f{op.flow},"
                             f" channels = [{cs}])")
            elif isinstance(op, BarrierOp):
                lines.append(f"  barrier(%f{op.flow},"
                             f" threads = {op.n_threads})")
        lines.append("}")
        return "\n".join(lines)


def plan_of(module: Module, fid: int) -> CommPlan:
    """Lower flow ``fid``'s partition-map + channel ops back to an
    ordinary :class:`~repro_torch.core.commplan.CommPlan` — the exact inverse
    of raising (``plan_of(raise_scenarios(...), fid) == sc.request()
    .plan`` field for field)."""
    fop = module.flows()[fid]
    pm = module.partition_maps()[fid]
    ch = module.channel_assigns()[fid]
    messages = tuple(
        WireMessage(index=m, items=g, nbytes=b, channel=c)
        for m, (g, b, c) in enumerate(zip(pm.groups, pm.nbytes,
                                          ch.channels)))
    return CommPlan(messages, fop.n_part)


def _plan_ops(fid: int, plan: CommPlan) -> List[object]:
    return [
        PartitionMapOp(flow=fid,
                       groups=tuple(m.items for m in plan.messages),
                       nbytes=tuple(m.nbytes for m in plan.messages)),
        ChannelAssignOp(flow=fid,
                        channels=tuple(m.channel for m in plan.messages)),
    ]


# --------------------------------------------------------------------------
# Raising


def _intern_ready(tables: List[np.ndarray], ready: np.ndarray) -> int:
    """Index of ``ready`` in ``tables``, appending when unseen."""
    key = (ready.shape, ready.tobytes())
    for i, t in enumerate(tables):
        if (t.shape, t.tobytes()) == key:
            return i
    tables.append(np.array(ready, dtype=float))
    return len(tables) - 1


def raise_scenarios(approach: str, scenarios: Sequence[Scenario], *,
                    n_ranks: int, n_vcis: int,
                    cfg: NetConfig = DEFAULT_NET,
                    tenants: Optional[Sequence[int]] = None) -> Module:
    """Lift a flow list (any driver's ``Scenario`` sequence, in the
    driver's enumeration order) into a module.

    Every flow's CommPlan — ``sc.request().plan``, the same plan
    ``commplan.make_plan``-style consumers build — is recorded as
    explicit partition-map + channel ops, so ``plan_of`` round-trips it
    losslessly for *every* schedule in the registry (the RMA epochs
    included; only :func:`execute` is restricted to pipelinable
    traffic).
    """
    if approach not in SCHEDULES:
        raise ValueError(f"unknown approach {approach!r};"
                         f" one of {tuple(SCHEDULES)}")
    tables: List[np.ndarray] = []
    ops: List[object] = []
    for fid, sc in enumerate(scenarios):
        rc = _intern_ready(tables, sc.ready)
        tenant = int(tenants[fid]) if tenants is not None else 0
        ops.append(FlowOp(src=int(sc.src), dst=int(sc.dst),
                          n_threads=sc.n_threads, theta=sc.theta,
                          part_bytes=float(sc.part_bytes), ready_class=rc,
                          t0=float(sc.t0),
                          aggr_bytes=float(sc.aggr_bytes), tenant=tenant))
        ops.extend(_plan_ops(fid, sc.request().plan))
        if approach == "part":
            ops.append(BarrierOp(flow=fid, n_threads=sc.n_threads))
    module = Module(approach=approach, n_ranks=n_ranks, n_vcis=n_vcis,
                    cfg=cfg, ready_tables=tuple(tables), ops=tuple(ops))
    module.validate()
    return module


def raise_stencil(approach: str, *, dims: Sequence[int] = (),
                  topo=None, periodic=True, theta: int,
                  n_threads: int = 1,
                  local_shape: Optional[Sequence[int]] = None,
                  bytes_per_cell: float = 8.0, halo_width: int = 1,
                  face_bytes: Optional[Sequence[float]] = None,
                  ready=None, n_vcis: int = 1, aggr_bytes: float = 0.0,
                  cfg: NetConfig = DEFAULT_NET,
                  dim_plans: Optional[Mapping[int, Tuple[int, float, int]]]
                  = None) -> Module:
    """Raise the N-D stencil scenario of
    :func:`repro_torch.core.simulator.simulate_stencil` into IR.

    Flow order is ``topo.flow_arrays()`` order — identical to the
    driver's — so executing the raised module reproduces the driver
    bit-for-bit on every engine.  ``dim_plans`` optionally overrides
    dimension ``d``'s plan with ``(theta_d, aggr_bytes_d,
    n_channels_d)`` (the pointwise ``plan_auto`` choice); it requires a
    trivial (None) ready table since the override changes theta.
    """
    topo, fb, _sched, _shared, ready_arr = sim._stencil_setup(
        approach, dims=dims, topo=topo, periodic=periodic, theta=theta,
        n_threads=n_threads, local_shape=local_shape,
        bytes_per_cell=bytes_per_cell, halo_width=halo_width,
        face_bytes=face_bytes, ready=ready)
    if dim_plans is not None and ready is not None:
        raise ValueError("dim_plans overrides theta per dimension; a"
                         " ready table shaped for the fixed theta cannot"
                         " apply — pass ready=None")
    srcs, dsts, fdims = topo.flow_arrays()
    scenarios = []
    for s, t, d in zip(srcs, dsts, fdims):
        if dim_plans is not None and int(d) in dim_plans:
            th, ag, nc = dim_plans[int(d)]
            scenarios.append(Scenario(
                n_threads=n_threads, theta=int(th),
                part_bytes=fb[d] / (n_threads * int(th)),
                ready=np.zeros((n_threads, int(th))), n_vcis=int(nc),
                aggr_bytes=float(ag), cfg=cfg, src=int(s), dst=int(t)))
        else:
            scenarios.append(Scenario(
                n_threads=n_threads, theta=theta,
                part_bytes=fb[d] / (n_threads * theta),
                ready=ready_arr[s], n_vcis=n_vcis,
                aggr_bytes=aggr_bytes, cfg=cfg, src=int(s), dst=int(t)))
    return raise_scenarios(approach, scenarios, n_ranks=topo.n_ranks,
                           n_vcis=n_vcis, cfg=cfg)


def raise_serving_wave(approach: str, *, arrival: str = "poisson",
                       rate_rps: float, n_requests: int,
                       n_tenants: int = 1, skew: float = 0.0,
                       n_stages: int = 4, theta: int, part_bytes: float,
                       n_vcis: int = 1, aggr_bytes: float = 0.0,
                       compute_us: float = 0.0, seed: int = 0,
                       cfg: NetConfig = DEFAULT_NET,
                       plan_spec: Optional[Tuple[int, float, int]] = None
                       ) -> Module:
    """Raise one admission wave of the open-loop serving scenario.

    Request ``r`` of the seeded trace contributes one pipeline-hop flow
    (stage ``r % (n_stages - 1)`` to the next) starting at its arrival
    time, stamped with its tenant exactly as
    :func:`repro_torch.core.simulator.simulate_serving` stamps waves (VCI and
    thread offset by the tenant id).  This is the wave's multi-flow
    traffic as one closed-form module — the open-loop driver's
    hop-to-hop feedback is dependent traffic the IR deliberately does
    not model.  ``plan_spec`` overrides the per-flow plan with the
    pointwise ``(theta, aggr_bytes, n_channels)`` choice.
    """
    if n_stages < 2:
        raise ValueError("n_stages must be at least 2 (one pipeline hop)")
    trace = make_trace(arrival, rate_rps, n_requests, n_tenants=n_tenants,
                       skew=skew, seed=seed)
    if plan_spec is None:
        th, ag, nc, pb = theta, aggr_bytes, n_vcis, part_bytes
    else:
        th, ag, nc = (int(plan_spec[0]), float(plan_spec[1]),
                      int(plan_spec[2]))
        pb = (theta * part_bytes) / th   # same payload, replanned split
    ready = np.zeros((1, th))
    if compute_us > 0.0:
        ready[0] = np.arange(1, th + 1) * (compute_us * US / th)
    scenarios = []
    tenants = []
    for r, t0 in enumerate(trace.t):
        hop = r % (n_stages - 1)
        scenarios.append(Scenario(n_threads=1, theta=th, part_bytes=pb,
                                  ready=ready, n_vcis=nc, aggr_bytes=ag,
                                  cfg=cfg, src=hop, dst=hop + 1,
                                  t0=float(t0)))
        tenants.append(int(trace.tenant[r]))
    return raise_scenarios(approach, scenarios, n_ranks=n_stages,
                           n_vcis=n_vcis, cfg=cfg, tenants=tenants)


def module_from_plan(plan: CommPlan, *, n_threads: int = 1,
                     part_bytes: float, n_vcis: int,
                     aggr_bytes: float = 0.0,
                     cfg: NetConfig = DEFAULT_NET,
                     approach: str = "part") -> Module:
    """A single-flow module carrying an existing uniform CommPlan — the
    ``plan_auto(pipeline=...)`` hook's raising step."""
    if plan.n_items % n_threads:
        raise ValueError(f"{plan.n_items} items do not split over"
                         f" {n_threads} threads")
    theta = plan.n_items // n_threads
    ops: List[object] = [FlowOp(src=0, dst=1, n_threads=n_threads,
                                theta=theta, part_bytes=float(part_bytes),
                                ready_class=0, aggr_bytes=float(aggr_bytes))]
    ops.extend(_plan_ops(0, plan))
    if approach == "part":
        ops.append(BarrierOp(flow=0, n_threads=n_threads))
    module = Module(approach=approach, n_ranks=2, n_vcis=n_vcis, cfg=cfg,
                    ready_tables=(np.zeros((n_threads, theta)),),
                    ops=tuple(ops))
    module.validate()
    return module


# --------------------------------------------------------------------------
# Lowering + execution


def _part_columns(module: Module, fop: FlowOp, pm: PartitionMapOp,
                  ch: ChannelAssignOp):
    """Intent columns of one partitioned flow from its IR plan —
    the exact arithmetic of ``PartitionedSchedule.intents`` with the
    op's groups/channels in place of the Scenario-derived plan, so an
    unmodified raise lowers to bit-identical columns."""
    cfg = module.cfg
    ready = module.ready_tables[fop.ready_class]
    start = fop.t0 + cfg.barrier(fop.n_threads)
    pready = np.empty(fop.n_part)
    bounce_free = 0.0
    for t in range(fop.n_threads):
        t_free = start
        for j in range(fop.theta):
            t_done = max(t_free, start + ready[t, j]) + cfg.alpha_atomic
            if fop.n_threads > 1:
                t_done = max(t_done, bounce_free) + cfg.alpha_bounce
                bounce_free = t_done
            pready[t * fop.theta + j] = t_done
            t_free = t_done
    n = len(pm.groups)
    t_ready = np.empty(n)
    thread = np.empty(n, dtype=np.int64)
    counter_free = 0.0
    for m, group in enumerate(pm.groups):
        tr = max(pready[p] for p in group)
        if fop.n_threads > 1:
            tr = max(tr, counter_free) + cfg.alpha_counter
            counter_free = tr
        t_ready[m] = tr
        thread[m] = group[-1] // fop.theta
    return (t_ready,
            np.array(pm.nbytes, dtype=np.float64),
            np.array(ch.channels, dtype=np.int64) + fop.tenant,
            thread + fop.tenant,
            np.zeros(n, dtype=bool), np.zeros(n, dtype=bool))


def _flow_scenario(module: Module, fop: FlowOp) -> Scenario:
    return Scenario(n_threads=fop.n_threads, theta=fop.theta,
                    part_bytes=fop.part_bytes,
                    ready=module.ready_tables[fop.ready_class],
                    n_vcis=module.n_vcis, aggr_bytes=fop.aggr_bytes,
                    cfg=module.cfg, src=fop.src, dst=fop.dst, t0=fop.t0)


def lower(module: Module):
    """Lower a module to flow-major merged intent columns.

    Returns ``(sched, flows, lens, cols)``: the registry schedule, one
    Scenario per flow (finish arithmetic), per-flow message counts, and
    the flow-major column dict (``pcount`` is partitions per message,
    feeding the fault layer's whole-message drop probability).
    """
    module.validate()
    if module.approach not in PIPELINED:
        raise ValueError(
            f"approach {module.approach!r} plans dependent traffic (RMA"
            f" epochs); the IR executes pipelinable schedules only:"
            f" {PIPELINED}")
    sched = SCHEDULES[module.approach]
    pmaps = module.partition_maps()
    chans = module.channel_assigns()
    flows: List[Scenario] = []
    parts: List[tuple] = []
    pcounts: List[np.ndarray] = []
    for fid, fop in enumerate(module.flows()):
        sc = _flow_scenario(module, fop)
        flows.append(sc)
        if module.approach == "part":
            cols = _part_columns(module, fop, pmaps[fid], chans[fid])
            pcounts.append(np.array([len(g) for g in pmaps[fid].groups],
                                    dtype=np.float64))
        else:
            batch = sched.intent_batch(sc)
            cols = (batch.t_ready, batch.nbytes,
                    batch.vci + fop.tenant, batch.thread + fop.tenant,
                    batch.put, batch.am_copy)
            pcounts.append(np.rint(batch.nbytes
                                   / max(fop.part_bytes, 1.0)))
        parts.append(cols)
    lens = np.array([c[0].shape[0] for c in parts], dtype=np.int64)
    srcs = np.array([sc.src for sc in flows], dtype=np.int64)
    dsts = np.array([sc.dst for sc in flows], dtype=np.int64)
    cols = {
        "t_ready": np.concatenate([c[0] for c in parts]),
        "nbytes": np.concatenate([c[1] for c in parts]),
        "vci": np.concatenate([c[2] for c in parts]),
        "thread": np.concatenate([c[3] for c in parts]),
        "put": np.concatenate([c[4] for c in parts]),
        "am_copy": np.concatenate([c[5] for c in parts]),
        "src": np.repeat(srcs, lens),
        "dst": np.repeat(dsts, lens),
        "pcount": np.concatenate(pcounts),
    }
    return sched, flows, lens, cols


@dataclass
class IRResult:
    """One executed module: per-rank completion + fault counters,
    mirroring the closed-loop drivers' results."""
    approach: str
    n_ranks: int
    rank_tts_s: List[float]
    time_s: float              # max completion minus compute
    tts_s: float
    n_messages: int            # wire messages incl. retransmissions
    n_wire: int                # planned messages across all flows
    n_flows: int
    n_retransmits: int = 0
    retrans_bytes: float = 0.0
    rounds: int = 1

    @property
    def time_us(self) -> float:
        return self.time_s / US

    @property
    def tts_us(self) -> float:
        return self.tts_s / US


def execute(module: Module, engine: str = "cuda", device="cuda",
            faults: Optional[FaultSpec] = None) -> IRResult:
    """Lower a module and run it on one of the four fabric engines.

    The merged columns go through the engines' streaming ``advance``
    entry point in global stable-sorted order — the identical order,
    tie-breaks included, to the closed-loop drivers' merge — so a
    freshly raised module reproduces its source driver bit-for-bit and
    the engines stay bit-for-bit with each other (float64).  Each call
    builds a fresh fabric.  With an active fault spec the
    retransmission loop of
    :func:`repro_torch.core.simulator.simulate_faulty` re-queues dropped
    messages into the live fabric (torch/cuda run on the batched NumPy
    fabric there, exactly like the faulty driver).  ``device`` is
    resolved before anything runs, so asking for the card where none is
    present raises even for a module that would stay on the host.
    """
    dev = resolve_device(device)
    sched, flows, lens, cols = lower(module)
    compute = max((float(module.ready_tables[f.ready_class].max())
                   for f in module.flows()), default=0.0)
    drops_on = faults is not None and faults.drops_enabled
    if faults is not None and not faults.is_noop:
        fab = make_faulty_fabric(engine, module.cfg, module.n_vcis,
                                 module.n_ranks, faults, device=dev)
    else:
        fab = sim._make_fabric(engine, module.cfg, module.n_vcis,
                               n_ranks=module.n_ranks, device=dev)
    n = int(cols["t_ready"].shape[0])
    n_retransmits = 0
    retrans_bytes = 0.0
    rounds = 1
    if not drops_on:
        order = np.argsort(cols["t_ready"], kind="stable")
        arr = fab.advance(cols["t_ready"][order], cols["nbytes"][order],
                          cols["vci"][order], cols["thread"][order],
                          cols["put"][order], cols["am_copy"][order],
                          cols["src"][order], cols["dst"][order])
        arrivals = np.empty_like(arr)
        arrivals[order] = arr
    else:
        p_msg = faults.message_drop_prob(cols["pcount"])
        draws = DropDraws(faults, n)
        arrivals = np.empty(n)
        t_cur = cols["t_ready"].copy()
        pend = np.arange(n)
        attempt = 0
        rounds = 0
        while pend.size:
            rounds += 1
            order = np.argsort(t_cur[pend], kind="stable")
            sel = pend[order]
            arr = fab.advance(t_cur[sel], cols["nbytes"][sel],
                              cols["vci"][sel], cols["thread"][sel],
                              cols["put"][sel], cols["am_copy"][sel],
                              cols["src"][sel], cols["dst"][sel])
            drop = draws.dropped(sel, attempt, p_msg[sel])
            arrivals[sel[~drop]] = arr[~drop]
            if drop.any():
                t_cur[sel[drop]] = (arr[drop] + faults.timeout_us * US
                                    * faults.backoff ** attempt)
                n_retransmits += int(drop.sum())
                retrans_bytes += float(cols["nbytes"][sel[drop]].sum())
            pend = np.sort(sel[drop])
            attempt += 1
    finished, _ = sim._finish_flows(sched, fab, flows, lens, arrivals)
    rank_tts = np.zeros(module.n_ranks)
    np.maximum.at(rank_tts, cols["dst"][np.cumsum(lens) - 1], finished)
    tts = float(rank_tts.max())
    return IRResult(approach=module.approach, n_ranks=module.n_ranks,
                    rank_tts_s=rank_tts.tolist(), time_s=tts - compute,
                    tts_s=tts, n_messages=fab.n_messages, n_wire=n,
                    n_flows=len(flows), n_retransmits=n_retransmits,
                    retrans_bytes=retrans_bytes, rounds=rounds)


# --------------------------------------------------------------------------
# Passes


class Pass:
    """One rewrite: ``run`` returns a new module (or the input unchanged
    when the pass does not apply).  ``identity = True`` promises the
    lowered columns are bit-for-bit unchanged — the equivalence suite
    verifies the promise; optimizing passes are instead measured by the
    pipeline's guard."""

    name: str = ""
    identity: bool = False

    def run(self, module: Module) -> Module:
        raise NotImplementedError


class Canonicalize(Pass):
    """Identity normalization: per-flow op grouping in flow order,
    channels reduced modulo the module's VCI count (the fabric applies
    the same modulo, so effective VCIs are unchanged), duplicate
    barriers dropped."""

    name = "canonicalize"
    identity = True

    def run(self, module: Module) -> Module:
        k = max(1, module.n_vcis)
        pmaps = module.partition_maps()
        chans = module.channel_assigns()
        barrs = module.barriers()
        ops: List[object] = []
        for fid, fop in enumerate(module.flows()):
            ops.append(fop)
            ops.append(pmaps[fid])
            ch = chans[fid]
            ops.append(replace(ch, channels=tuple(c % k
                                                  for c in ch.channels)))
            if fid in barrs:
                ops.append(barrs[fid])
        return replace(module, ops=tuple(ops))


def _regroup(groups: Sequence[Tuple[int, ...]], nbytes: Sequence[float],
             bound: float):
    """Merge adjacent groups while the running payload stays <= bound
    (an upper bound: a group never splits, an oversized group stands
    alone).  ``starts[i]`` is the original index of run i's first group
    (its channel survives the merge)."""
    out_g: List[Tuple[int, ...]] = []
    out_b: List[float] = []
    starts: List[int] = []
    for m, (g, b) in enumerate(zip(groups, nbytes)):
        if out_g and out_b[-1] + b <= bound:
            out_g[-1] = out_g[-1] + tuple(g)
            out_b[-1] += b
        else:
            out_g.append(tuple(g))
            out_b.append(float(b))
            starts.append(m)
    return tuple(out_g), tuple(out_b), tuple(starts)


class FuseFaces(Pass):
    """Merge flows sharing a (src, dst) link and plan shape — adjacent
    stencil faces of one dimension both land on the same neighbor in a
    periodic size-2 torus — into a single flow, then aggregate across
    the former face boundary under the flows' bound.  Partitioned
    schedule only (the rewrite re-shapes partition ids); measured by the
    pipeline guard."""

    name = "fuse-faces"

    def run(self, module: Module) -> Module:
        if module.approach != "part":
            return module
        flows = module.flows()
        pmaps = module.partition_maps()
        chans = module.channel_assigns()
        groups_by_key: Dict[tuple, List[int]] = {}
        for fid, fop in enumerate(flows):
            key = (fop.src, fop.dst, fop.n_threads, fop.part_bytes,
                   fop.ready_class, fop.t0, fop.tenant)
            groups_by_key.setdefault(key, []).append(fid)
        if all(len(v) < 2 for v in groups_by_key.values()):
            return module
        tables = list(module.ready_tables)
        fused_of: Dict[int, int] = {}   # old fid -> group leader fid
        fused_ops: Dict[int, List[object]] = {}
        for members in groups_by_key.values():
            if len(members) < 2:
                continue
            leader = members[0]
            fops = [flows[f] for f in members]
            lead = fops[0]
            theta_new = sum(f.theta for f in fops)
            # merged ready: thread t's partitions are the member flows'
            # rows concatenated in member order
            ready_new = np.concatenate(
                [module.ready_tables[f.ready_class] for f in fops],
                axis=1)
            rc = _intern_ready(tables, ready_new)
            offs = np.cumsum([0] + [f.theta for f in fops[:-1]])
            new_groups: List[Tuple[int, ...]] = []
            new_bytes: List[float] = []
            new_chans: List[int] = []
            for f, off in zip(members, offs.tolist()):
                fop = flows[f]
                for g, b, c in zip(pmaps[f].groups, pmaps[f].nbytes,
                                   chans[f].channels):
                    remapped = tuple(
                        (p // fop.theta) * theta_new + off
                        + (p % fop.theta) for p in g)
                    new_groups.append(remapped)
                    new_bytes.append(b)
                    new_chans.append(c)
            aggr = max(f.aggr_bytes for f in fops)
            if aggr > 0.0:
                merged_g, merged_b, starts = _regroup(new_groups,
                                                      new_bytes, aggr)
                if len(merged_g) < len(new_groups):
                    new_groups, new_bytes = list(merged_g), list(merged_b)
                    new_chans = [new_chans[s] for s in starts]
            fop_new = replace(lead, theta=theta_new, ready_class=rc,
                              aggr_bytes=aggr)
            body: List[object] = [
                fop_new,
                PartitionMapOp(flow=leader, groups=tuple(new_groups),
                               nbytes=tuple(new_bytes)),
                ChannelAssignOp(flow=leader, channels=tuple(new_chans)),
                BarrierOp(flow=leader, n_threads=lead.n_threads),
            ]
            fused_ops[leader] = body
            for f in members:
                fused_of[f] = leader
        # rebuild the op stream: surviving flows keep their relative
        # order; fused members collapse onto their leader's position
        barrs = module.barriers()
        ops: List[object] = []
        new_fid: Dict[int, int] = {}
        for fid in range(len(flows)):
            if fid in fused_of and fused_of[fid] != fid:
                continue
            new_fid[fid] = len(new_fid)
        for fid, fop in enumerate(flows):
            if fid in fused_of and fused_of[fid] != fid:
                continue
            nid = new_fid[fid]
            if fid in fused_ops:
                for op in fused_ops[fid]:
                    ops.append(op if isinstance(op, FlowOp)
                               else replace(op, flow=nid))
            else:
                ops.append(fop)
                ops.append(replace(pmaps[fid], flow=nid))
                ops.append(replace(chans[fid], flow=nid))
                if fid in barrs:
                    ops.append(replace(barrs[fid], flow=nid))
        out = replace(module, ready_tables=tuple(tables), ops=tuple(ops))
        out.validate()
        return out


class MergeSmallFlows(Pass):
    """Coalesce sub-aggregation-bound wire messages ahead of the NIC:
    each partitioned flow's adjacent groups merge while the combined
    payload stays under ``bound`` (default: the fabric's
    bcopy/rendezvous switch, the last size a message is cheap to copy
    at).  Pointwise plans with aggregation disabled inject one message
    per partition; this pass turns a sub-bound flow into a handful of
    messages, shedding per-message VCI/NIC/wire overheads.  Measured by
    the pipeline guard."""

    name = "merge-small-flows"

    def __init__(self, bound: Optional[float] = None):
        self.bound = bound

    def run(self, module: Module) -> Module:
        if module.approach != "part":
            return module
        bound = float(self.bound if self.bound is not None
                      else module.cfg.bcopy_max)
        merged = {fid: _regroup(pm.groups, pm.nbytes, bound)
                  for fid, pm in module.partition_maps().items()}
        pmaps = module.partition_maps()
        changed = False
        ops: List[object] = []
        for op in module.ops:
            if isinstance(op, PartitionMapOp):
                g, b, _ = merged[op.flow]
                if len(g) < len(op.groups):
                    changed = True
                    ops.append(replace(op, groups=g, nbytes=b))
                else:
                    ops.append(op)
            elif isinstance(op, ChannelAssignOp):
                g, _, starts = merged[op.flow]
                if len(g) < len(pmaps[op.flow].groups):
                    ops.append(replace(
                        op,
                        channels=tuple(op.channels[s] for s in starts)))
                else:
                    ops.append(op)
            else:
                ops.append(op)
        if not changed:
            return module
        out = replace(module, ops=tuple(ops))
        out.validate()
        return out


class GlobalChannels(Pass):
    """Reassign VCIs round-robin across *all* messages a rank injects,
    in flow-major order, instead of restarting the round-robin at VCI 0
    for every flow — per-flow restarts pile every flow's early messages
    onto the low VCIs of a shared bank.  Partitioned schedule only;
    measured by the pipeline guard."""

    name = "global-channels"

    def run(self, module: Module) -> Module:
        if module.approach != "part":
            return module
        k = max(1, module.n_vcis)
        counters: Dict[int, int] = {}
        flows = module.flows()
        pmaps = module.partition_maps()
        new_chans: Dict[int, Tuple[int, ...]] = {}
        for fid, fop in enumerate(flows):
            c0 = counters.get(fop.src, 0)
            n = len(pmaps[fid].groups)
            new_chans[fid] = tuple((c0 + m) % k for m in range(n))
            counters[fop.src] = c0 + n
        changed = False
        ops: List[object] = []
        for op in module.ops:
            if isinstance(op, ChannelAssignOp):
                old_eff = tuple(c % k for c in op.channels)
                if new_chans[op.flow] != old_eff:
                    changed = True
                    ops.append(replace(op, channels=new_chans[op.flow]))
                else:
                    ops.append(op)
            else:
                ops.append(op)
        return replace(module, ops=tuple(ops)) if changed else module


PASSES: Dict[str, type] = {
    p.name: p for p in (Canonicalize, FuseFaces, MergeSmallFlows,
                        GlobalChannels)
}


class PassPipeline:
    """A pass sequence with a measured acceptance guard.

    Identity passes apply unconditionally (their bit-for-bit promise is
    held by the equivalence suite).  Every *optimizing* rewrite is
    simulated on ``engine`` (on ``device``) and kept only when the
    module's total time does not increase — so ``run`` never returns a
    module slower than its input, whatever the passes do.  ``faults``
    prices rewrites on the faulty fabric (retransmission traffic
    included), matching how the optimized module will actually run.
    ``run`` resolves ``device`` before it rewrites anything.
    """

    def __init__(self, passes: Optional[Sequence[Pass]] = None, *,
                 guard: bool = True, engine: str = "cuda", device="cuda"):
        self.passes = list(passes) if passes is not None else [
            Canonicalize(), FuseFaces(), MergeSmallFlows(),
            GlobalChannels()]
        self.guard = guard
        self.engine = engine
        self.device = device
        self.applied: List[str] = []   # pass names kept on the last run

    def run(self, module: Module,
            faults: Optional[FaultSpec] = None) -> Module:
        dev = resolve_device(self.device)
        self.applied = []
        best = module
        best_t: Optional[float] = None
        for p in self.passes:
            cand = p.run(best)
            if cand is best:
                continue
            if p.identity or not self.guard:
                best = cand
                self.applied.append(p.name)
                continue
            if best_t is None:
                best_t = execute(best, self.engine, dev,
                                 faults=faults).tts_s
            t = execute(cand, self.engine, dev, faults=faults).tts_s
            if t <= best_t:
                best, best_t = cand, t
                self.applied.append(p.name)
        return best


def default_pipeline(**kw) -> PassPipeline:
    """The standard guarded pipeline: canonicalize, fuse-faces,
    merge-small-flows, global-channels."""
    return PassPipeline(**kw)


def optimize_plan(plan: CommPlan, pipeline: PassPipeline, *,
                  n_threads: int = 1, part_bytes: float, n_vcis: int,
                  aggr_bytes: float = 0.0, cfg: Optional[NetConfig] = None,
                  faults: Optional[FaultSpec] = None) -> CommPlan:
    """Run a pass pipeline over one uniform plan and lower it back —
    the implementation behind ``plan_auto(pipeline=...)``."""
    module = module_from_plan(plan, n_threads=n_threads,
                              part_bytes=part_bytes, n_vcis=n_vcis,
                              aggr_bytes=aggr_bytes,
                              cfg=cfg if cfg is not None else DEFAULT_NET)
    out = pipeline.run(module, faults=faults)
    return plan_of(out, 0)
