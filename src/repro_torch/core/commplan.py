"""CommPlan: the single source of truth for partition -> wire-message plans.

The paper's core abstraction (§3.2.1-§3.2.2) is one mechanism applied in
three places: a buffer is divided into *items* (MPI partitions, gradient
leaves, array rows), items are aggregated into *wire messages* under an
upper bound (``MPIR_CVAR_PART_AGGR_SIZE``), and messages are assigned
round-robin onto *channels* (MPICH's VCIs, XLA's collective channel ids).
This module owns that mechanism once; everything else consumes it:

  * ``partition.PartitionedRequest``  -> :func:`plan_uniform`
    (gcd sender/receiver agreement, grouped aggregation);
  * ``bucketing.make_plan``           -> :func:`plan_sized`
    (heterogeneous leaves, greedy aggregation);
  * channel streams                   -> :func:`channel_slices`
    (round-robin row -> channel interleaving);
  * the planner's choice              -> :func:`plan_auto`.

Plans are immutable and carry a precomputed item -> message index, so
``message_of_item`` is O(1) however many partitions the request has.

The PyTorch port's own copy of the JAX package's plan layer.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple


def agree_message_count(n_send: int, n_recv: int) -> int:
    """Paper §3.2.1: receiver picks gcd(N_send, N_recv) base messages."""
    if n_send <= 0 or n_recv <= 0:
        raise ValueError("partition counts must be positive")
    return math.gcd(n_send, n_recv)


def aggregate_message_count(n_messages: int, message_bytes: float,
                            aggr_bytes: float) -> int:
    """Number of wire messages after aggregation under an upper bound.

    ``aggr_bytes`` is an upper bound: messages are merged while the merged
    size stays <= aggr_bytes.  Each wire message is a whole number of base
    messages (partitions never split across wire messages).
    """
    if n_messages <= 0:
        raise ValueError("n_messages must be positive")
    if aggr_bytes <= 0 or message_bytes <= 0:
        return n_messages
    group = max(1, int(aggr_bytes // message_bytes))
    return math.ceil(n_messages / group)


def assign_channels(n_messages: int, n_channels: int) -> Tuple[int, ...]:
    """Round-robin message -> channel map (the paper's VCI mapping)."""
    k = max(1, n_channels)
    return tuple(m % k for m in range(n_messages))


def channel_streams(n_items: int, n_channels: int) -> List[Tuple[int, ...]]:
    """Per-channel item-index tuples under round-robin interleaving.

    ``channel_streams(6, 2) == [(0, 2, 4), (1, 3, 5)]`` — the index-space
    counterpart of slicing an array with :func:`channel_slices`.
    """
    k = max(1, n_channels)
    return [tuple(range(c, n_items, k)) for c in range(k)]


def channel_slices(n_items: int, n_channels: int) -> List[slice]:
    """Round-robin slices splitting ``n_items`` rows into channel streams.

    Stream c is ``x[channel_slices(n, k)[c]]``; requires ``n % k == 0`` for
    equal streams (callers that need balance assert this).
    """
    k = max(1, n_channels)
    return [slice(c, None, k) for c in range(k)]


@dataclass(frozen=True)
class WireMessage:
    """One wire message: a contiguous run of items on one channel."""
    index: int                 # message index within the plan
    items: Tuple[int, ...]     # item ids contributing to this message
    nbytes: float              # payload size
    channel: int               # VCI / collective channel id

    @property
    def partitions(self) -> Tuple[int, ...]:
        """MPI-speak alias: the partition ids of this message."""
        return self.items


@dataclass(frozen=True)
class CommPlan:
    """Immutable aggregation + channel-assignment plan over n_items items."""
    messages: Tuple[WireMessage, ...]
    n_items: int
    # item id -> message index, built once (O(1) message_of_item).
    _index: Tuple[int, ...] = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        idx = [-1] * self.n_items
        for msg in self.messages:
            for item in msg.items:
                if not 0 <= item < self.n_items or idx[item] != -1:
                    raise ValueError(
                        f"item {item} not covered exactly once")
                idx[item] = msg.index
        if any(i == -1 for i in idx):
            raise ValueError("plan does not cover every item")
        object.__setattr__(self, "_index", tuple(idx))

    @property
    def n_messages(self) -> int:
        return len(self.messages)

    @property
    def total_bytes(self) -> float:
        return sum(m.nbytes for m in self.messages)

    @property
    def n_channels_used(self) -> int:
        return len({m.channel for m in self.messages})

    def message_of_item(self, item: int) -> WireMessage:
        """O(1) lookup of the wire message an item belongs to."""
        if not 0 <= item < self.n_items:
            raise KeyError(item)
        return self.messages[self._index[item]]

    def channel_messages(self, channel: int) -> Tuple[WireMessage, ...]:
        return tuple(m for m in self.messages if m.channel == channel)

    def ready_times_to_send_times(self, ready: Sequence[float]
                                  ) -> List[float]:
        """Earliest time each wire message is complete (all items ready).

        ``ready[i]`` = time item i is marked MPI_Pready.  A message can be
        injected once *all* of its items are ready (the atomic counter of
        §3.2.2 reaching zero).
        """
        if len(ready) != self.n_items:
            raise ValueError("need one ready time per item")
        return [max(ready[p] for p in msg.items) for msg in self.messages]


def plan_uniform(n_send: int, n_recv: int, item_bytes: float, *,
                 aggr_bytes: float = 0.0, n_channels: int = 1) -> CommPlan:
    """Plan for uniform partitions with sender/receiver agreement (§3.2.1).

    The sender and receiver may declare different partition counts; the
    number of base messages is ``gcd(n_send, n_recv)`` so every partition
    contributes to exactly one message.  Base messages are then merged in
    contiguous groups while the merged size stays <= ``aggr_bytes`` (an
    upper bound — a base message never splits), and wire messages map
    round-robin onto ``n_channels``.
    """
    n_base = agree_message_count(n_send, n_recv)
    parts_per_base = n_send // n_base
    base_bytes = item_bytes * parts_per_base
    n_wire = aggregate_message_count(n_base, base_bytes, aggr_bytes)
    group = math.ceil(n_base / n_wire)
    channels = assign_channels(n_wire, n_channels)
    messages = []
    for m in range(n_wire):
        base_lo, base_hi = m * group, min((m + 1) * group, n_base)
        ids = tuple(range(base_lo * parts_per_base,
                          base_hi * parts_per_base))
        messages.append(WireMessage(index=m, items=ids,
                                    nbytes=len(ids) * item_bytes,
                                    channel=channels[m]))
    return CommPlan(tuple(messages), n_send)


def plan_sized(sizes: Sequence[float], *, aggr_bytes: float = 0.0,
               n_channels: int = 1) -> CommPlan:
    """Greedy plan for heterogeneous item sizes (gradient-leaf bucketing).

    Items are merged in order while the running size stays <= ``aggr_bytes``
    (upper bound: an item larger than the threshold forms its own message,
    it is never split).  ``aggr_bytes <= 0`` disables aggregation — one
    message per item.  Messages map round-robin onto ``n_channels``.
    """
    k = max(1, n_channels)
    messages: List[WireMessage] = []
    cur_ids: List[int] = []
    cur_bytes = 0.0

    def flush():
        nonlocal cur_ids, cur_bytes
        if cur_ids:
            m = len(messages)
            messages.append(WireMessage(index=m, items=tuple(cur_ids),
                                        nbytes=cur_bytes, channel=m % k))
            cur_ids, cur_bytes = [], 0.0

    for i, b in enumerate(sizes):
        if aggr_bytes > 0 and cur_bytes + b > aggr_bytes and cur_ids:
            flush()
        cur_ids.append(i)
        cur_bytes += b
        if aggr_bytes <= 0:  # aggregation disabled: one message per item
            flush()
    flush()
    return CommPlan(tuple(messages), len(sizes))


def plan_auto(total_bytes: float = None, *, sizes: Sequence[float] = None,
              n_threads: int = 1, workload=None, cfg=None,
              max_parts: int = 512, max_vcis: int = 32, faults=None,
              policy=None, pipeline=None):
    """Model-chosen plan: the :mod:`repro_torch.core.planner` autotuner picks
    the partition count, aggregation bound and channel count from the
    closed-form performance model, then the matching planner builds the
    plan.

    Two forms, mirroring the two planners above:

    * ``plan_auto(total_bytes, n_threads=...)`` — uniform partitions:
      the chosen ``theta`` fixes ``n_threads * theta`` partitions,
      planned by :func:`plan_uniform`;
    * ``plan_auto(sizes=[...])`` — heterogeneous items (gradient
      leaves): item sizes are given, only the aggregation bound and
      channel count are chosen, planned by :func:`plan_sized`.

    ``workload`` (a :class:`~repro_torch.core.perfmodel.Workload`) describes
    the compute profile whose ramp the plan should overlap; ``cfg`` a
    :class:`~repro_torch.core.fabric.NetConfig` (defaults to the MeluXina-like
    calibration).  ``faults`` (a :class:`~repro_torch.core.faults.FaultSpec`)
    makes the model charge each candidate its expected retransmission
    cost, shifting the pick away from heavily aggregated plans when the
    fabric drops partitions; ``policy`` (a :class:`~repro_torch.core.recovery
    .RecoveryPolicy`) prices that term under the matching recovery
    clock instead of the fixed timeout.  Returns ``(plan, choice)`` — the immutable
    :class:`CommPlan` plus the :class:`~repro_torch.core.planner.PlanChoice`
    with the model's predicted time and term breakdown.

    ``pipeline`` (a :class:`~repro_torch.core.plan_ir.PassPipeline`) runs the
    model's pointwise pick through the IR optimization passes and
    returns the rewritten plan — the pipeline's measured guard keeps a
    rewrite only when the simulated flow time does not increase, so the
    returned plan is never worse than the pointwise one.  Uniform form
    only: the heterogeneous ``sizes`` form has no single partition size
    for the IR's flow op to carry.
    """
    from . import planner  # deferred: planner imports this module
    if (total_bytes is None) == (sizes is None):
        raise ValueError("pass exactly one of total_bytes or sizes")
    if pipeline is not None and sizes is not None:
        raise ValueError("pipeline= applies to the uniform form only;"
                         " heterogeneous sizes have no single part_bytes"
                         " for the IR flow op")
    if sizes is not None:
        total_bytes = float(sum(sizes))
    if policy is not None:
        from .recovery import make_policy
        policy = make_policy(policy)  # accept names as well as instances
    kw = {} if cfg is None else {"cfg": cfg}
    desc = planner.ScenarioDesc(total_bytes=float(total_bytes),
                                n_threads=n_threads, workload=workload,
                                max_parts=max_parts, max_vcis=max_vcis,
                                faults=faults, policy=policy, **kw)
    choice = planner.choose_plan(desc, approaches=("part",))
    if sizes is not None:
        plan = plan_sized(sizes, aggr_bytes=choice.aggr_bytes,
                          n_channels=choice.n_vcis)
    else:
        n_part = n_threads * choice.theta
        plan = plan_uniform(n_part, n_part, total_bytes / n_part,
                            aggr_bytes=choice.aggr_bytes,
                            n_channels=choice.n_vcis)
        if pipeline is not None:
            from . import plan_ir  # deferred: plan_ir imports this module
            plan = plan_ir.optimize_plan(
                plan, pipeline, n_threads=n_threads,
                part_bytes=total_bytes / n_part, n_vcis=choice.n_vcis,
                aggr_bytes=choice.aggr_bytes, cfg=cfg, faults=faults)
    return plan, choice
