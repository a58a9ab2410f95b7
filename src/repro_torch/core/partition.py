"""Partitioned-request semantics on top of the CommPlan layer.

This module carries the *API shape* of MPI-4.0 partitioned communication as
implemented by the paper (§3.2.1) — ``MPI_Psend_init`` fixes partition
counts, sizes, aggregation and channel mapping once; the request then
holds the agreed wire plan for reuse across iterations.  All planning
logic (gcd sender/receiver agreement, aggregation upper bound, round-robin
channel assignment) lives in :mod:`repro_torch.core.commplan`; this is a
thin consumer kept for the simulator and for MPI-flavoured naming;
:meth:`PartitionedRequest.auto` lets the planner pick the plan.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

from . import commplan
from .commplan import (WireMessage, agree_message_count,  # noqa: F401
                       aggregate_message_count)

# Backward-compatible alias: a wire message is a run of partitions.
Message = WireMessage


@dataclass
class PartitionedRequest:
    """Static plan for one partitioned send/recv request.

    Mirrors MPI_Psend_init: fixes partition counts, sizes, aggregation and
    channel mapping once; `messages` is the agreed wire plan.
    """
    n_send_parts: int
    n_recv_parts: int
    part_bytes: float
    aggr_bytes: float = 0.0
    n_channels: int = 1
    plan: commplan.CommPlan = field(init=False, repr=False)
    messages: List[Message] = field(default_factory=list)

    def __post_init__(self):
        self.plan = commplan.plan_uniform(
            self.n_send_parts, self.n_recv_parts, self.part_bytes,
            aggr_bytes=self.aggr_bytes, n_channels=self.n_channels)
        self.messages = list(self.plan.messages)
        self.choice = None  # set by :meth:`auto`

    @classmethod
    def auto(cls, total_bytes: float, n_threads: int = 1, *,
             workload=None, cfg=None, max_parts: int = 512,
             max_vcis: int = 32) -> "PartitionedRequest":
        """Self-configuring ``MPI_Psend_init``: the
        :mod:`repro_torch.core.planner` autotuner picks the partition count,
        aggregation bound and channel count from the closed-form model
        (restricted to the partitioned approach), given the payload and
        the compute profile (``workload``).  The model's
        :class:`~repro_torch.core.planner.PlanChoice` is kept on ``.choice``.
        """
        from . import planner  # deferred: planner imports commplan
        kw = {} if cfg is None else {"cfg": cfg}
        desc = planner.ScenarioDesc(total_bytes=float(total_bytes),
                                    n_threads=n_threads, workload=workload,
                                    max_parts=max_parts, max_vcis=max_vcis,
                                    **kw)
        choice = planner.choose_plan(desc, approaches=("part",))
        n_part = n_threads * choice.theta
        req = cls(n_part, n_part, total_bytes / n_part,
                  aggr_bytes=choice.aggr_bytes, n_channels=choice.n_vcis)
        req.choice = choice
        return req

    @property
    def n_messages(self) -> int:
        return self.plan.n_messages

    def message_of_partition(self, part_id: int) -> Message:
        """O(1): served from the plan's precomputed partition index."""
        return self.plan.message_of_item(part_id)

    def ready_times_to_send_times(self, ready: Sequence[float]) -> List[float]:
        """Earliest time each wire message is complete (all partitions ready).

        ``ready[i]`` = time partition i is marked MPI_Pready.  A message can
        be injected once *all* of its partitions are ready (the atomic
        counter of §3.2.2 reaching zero).
        """
        if len(ready) != self.n_send_parts:
            raise ValueError("need one ready time per partition")
        return self.plan.ready_times_to_send_times(ready)
