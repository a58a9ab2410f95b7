"""Seeded fault injection for the fabric engines.

The port's copy of the JAX package's ``core/faults.py``: host NumPy,
unchanged in its arithmetic, with the port's fabrics underneath.

The paper measures partitioned communication on a *healthy* fabric; this
module supplies the perturbed one.  Three fault classes, all declared up
front in a frozen :class:`FaultSpec` and all wall-clock-free (like
:mod:`repro_torch.core.arrivals`, a faulty run is a pure function of its
parameters and seed):

  * **partition drops** — every wire message is dropped independently
    with a probability that *composes per partition carried*: a message
    aggregating k partitions is lost whenever any of its k chunks is,
    ``p_msg = 1 - (1 - drop_prob) ** k``.  This is the mechanism behind
    the robustness claim: the pt2pt_single bulk message carries *all*
    partitions (near-certain loss, whole-buffer retransmit) while the
    partitioned path only retransmits the lost chunks.  Dropped messages
    re-enter the VCI/NIC/wire queues as retransmission traffic after a
    timeout with exponential backoff — they pay real queue contention,
    not a closed-form penalty.
  * **link degradation** — a :class:`LinkDegrade` window multiplies a
    link's bandwidth by ``factor`` while the transfer *starts* inside
    ``[t_start_us, t_end_us)``.  Endpoint ``None`` wildcards all links.
  * **rank failures** — :class:`RankFailure` events (leave at
    ``t_fail_us``, optional rejoin at ``t_recover_us``).  These are not
    fabric-level faults: the membership driver
    (:func:`repro_torch.core.simulator.simulate_membership`) consumes them to
    trigger CommPlan re-agreement over the surviving grid.

Drop verdicts come from :class:`DropDraws`: a pre-drawn uniform matrix
``U[message, attempt]`` from a ``SeedSequence``, so the verdict for
(message m, attempt a) is independent of the engine, the round order and
everything else — which is what keeps the reference and vector engines
bit-for-bit identical under faults.  Attempt ``max_retries`` always
succeeds, bounding every run.

The faulty fabrics (:class:`FaultyReferenceFabric`,
:class:`FaultyFabric`) override only the wire-stage seams
(``_wire_service`` / ``_wire_scan``) of :mod:`repro_torch.core.fabric`; with
``factor == 1.0`` the degraded service is ``nbytes / (beta * 1.0)`` —
bitwise identical to the healthy ``nbytes / beta``, so an empty fault
spec is a guaranteed no-op.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from .fabric import US, Fabric, NetConfig, ReferenceFabric, _queue_scan
from .fabric_torch import resolve_device
from .recovery import (DEFAULT_BACKOFF, DEFAULT_MAX_RETRIES,
                       DEFAULT_TIMEOUT_US, RecoveryPolicy)


@dataclass(frozen=True)
class LinkDegrade:
    """Bandwidth degradation window on a (src, dst) link.

    While a transfer *starts* inside ``[t_start_us, t_end_us)`` on a
    matching link, the wire serves at ``beta * factor``.  ``None``
    endpoints wildcard; overlapping windows compose multiplicatively in
    declaration order.
    """
    t_start_us: float
    t_end_us: float
    factor: float
    src: Optional[int] = None
    dst: Optional[int] = None

    def __post_init__(self):
        if not 0.0 < self.factor <= 1.0:
            raise ValueError(
                f"degradation factor must be in (0, 1], got {self.factor}")
        if self.t_start_us < 0.0:
            # a negative window start can never match a transfer (the
            # fabric clock starts at 0) — reject it loudly instead of
            # silently declaring a dead window
            raise ValueError(
                f"t_start_us must be non-negative, got {self.t_start_us}")
        if self.t_end_us <= self.t_start_us:
            raise ValueError(
                f"degradation window must have t_end_us > t_start_us, got "
                f"[{self.t_start_us}, {self.t_end_us}]")


@dataclass(frozen=True)
class RankFailure:
    """A rank leaves the job at ``t_fail_us`` and, if ``t_recover_us``
    is set, rejoins then.  Consumed by the membership driver, which
    re-plans the mesh (``runtime.elastic.plan_mesh``) and re-agrees the
    CommPlan over the survivors; the fabric itself never sees these."""
    rank: int
    t_fail_us: float
    t_recover_us: Optional[float] = None

    def __post_init__(self):
        if self.rank < 0:
            raise ValueError(f"rank must be non-negative, got {self.rank}")
        if self.t_fail_us < 0.0:
            raise ValueError(
                f"t_fail_us must be non-negative, got {self.t_fail_us}")
        if self.t_recover_us is not None \
                and self.t_recover_us <= self.t_fail_us:
            raise ValueError(
                f"t_recover_us ({self.t_recover_us}) must be after "
                f"t_fail_us ({self.t_fail_us})")


@dataclass(frozen=True)
class FaultSpec:
    """Everything the fault injector may do to one run, declared up
    front.  ``drop_prob`` is *per partition*; retransmission attempt a
    waits ``timeout_us * backoff ** a`` after the (would-be) delivery
    before re-entering the queues (under the default ``fixed`` recovery
    policy — :mod:`repro_torch.core.recovery` makes the clock pluggable), and
    attempt ``max_retries`` always succeeds.  ``seed`` drives every
    random verdict via ``SeedSequence`` — no wall clock anywhere.  The
    retry defaults are the shared :mod:`repro_torch.core.recovery` constants,
    the same ones the runtime's retry loop uses."""
    drop_prob: float = 0.0
    timeout_us: float = DEFAULT_TIMEOUT_US
    backoff: float = DEFAULT_BACKOFF
    max_retries: int = DEFAULT_MAX_RETRIES
    degradations: Tuple[LinkDegrade, ...] = ()
    failures: Tuple[RankFailure, ...] = ()
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.drop_prob < 1.0:
            raise ValueError(
                f"drop_prob must be in [0, 1), got {self.drop_prob}")
        if self.timeout_us <= 0.0:
            raise ValueError(
                f"timeout_us must be positive, got {self.timeout_us}")
        if self.backoff < 1.0:
            raise ValueError(f"backoff must be >= 1, got {self.backoff}")
        if self.max_retries < 1:
            raise ValueError(
                f"max_retries must be >= 1, got {self.max_retries}")
        object.__setattr__(self, "degradations", tuple(self.degradations))
        object.__setattr__(self, "failures", tuple(self.failures))

    @property
    def drops_enabled(self) -> bool:
        return self.drop_prob > 0.0

    @property
    def is_noop(self) -> bool:
        """True when the *fabric* is healthy: no drops, no degradation.
        Rank failures don't count — they live above the fabric, in the
        membership driver."""
        return not self.drops_enabled and not self.degradations

    def message_drop_prob(self, parts):
        """Drop probability of a message carrying ``parts`` partitions
        (scalar or array): independent per-partition loss composed,
        ``1 - (1 - p) ** parts``.  Zero partitions (0-byte sync
        messages) are immune."""
        return 1.0 - (1.0 - self.drop_prob) ** parts

    def wire_factor(self, src: int, dst: int, t: float) -> float:
        """Bandwidth factor on link (src, dst) for a transfer starting
        at ``t`` (seconds).  1.0 when no window matches — and the faulty
        fabrics' ``nbytes / (beta * 1.0)`` is then bitwise identical to
        the healthy ``nbytes / beta``."""
        fac = 1.0
        for d in self.degradations:
            if (d.src is None or d.src == src) \
                    and (d.dst is None or d.dst == dst) \
                    and d.t_start_us * US <= t < d.t_end_us * US:
                fac = fac * d.factor
        return fac

    def wire_factor_array(self, src: np.ndarray, dst: np.ndarray,
                          t: np.ndarray) -> np.ndarray:
        """Vector counterpart of :meth:`wire_factor`: same windows
        applied in the same declaration order, elementwise — identical
        IEEE-754 products, so the engines stay bit-for-bit."""
        fac = np.ones_like(t)
        for d in self.degradations:
            m = (d.t_start_us * US <= t) & (t < d.t_end_us * US)
            if d.src is not None:
                m &= src == d.src
            if d.dst is not None:
                m &= dst == d.dst
            fac = np.where(m, fac * d.factor, fac)
        return fac


#: Hard cap on a :class:`DropDraws` verdict matrix, in entries
#: (``n_messages * max_retries``).  2**25 float64 entries is 256 MiB —
#: comfortably above every committed grid (the 32k-rank weak-scaling
#: sweep draws ~13M entries) while refusing the multi-GB allocations an
#: XXL grid with a large retry budget would otherwise make silently.
MAX_DRAW_ENTRIES = 2 ** 25


class DropDraws:
    """Pre-drawn drop verdicts for one run: ``U[message, attempt]``
    uniforms from ``SeedSequence([seed, *extra])``.  Message m's attempt
    a is dropped iff ``a < max_retries`` and ``U[m, a] < p_msg[m]`` — a
    pure function of (message id, attempt), independent of engine and
    round structure.  ``extra`` entropy (e.g. the serving wave index)
    keeps per-wave draws independent yet reproducible.  Allocation is
    guarded by :data:`MAX_DRAW_ENTRIES`."""

    def __init__(self, spec: FaultSpec, n_messages: int,
                 extra: Sequence[int] = ()):
        entries = int(n_messages) * spec.max_retries
        if entries > MAX_DRAW_ENTRIES:
            raise ValueError(
                f"DropDraws allocation too large: n_messages "
                f"({int(n_messages)}) * max_retries ({spec.max_retries}) "
                f"= {entries} entries exceeds MAX_DRAW_ENTRIES "
                f"({MAX_DRAW_ENTRIES}); shrink the grid or the retry "
                f"budget")
        self.max_retries = spec.max_retries
        ss = np.random.SeedSequence([spec.seed, *extra])
        self.u = np.random.default_rng(ss).random(
            (int(n_messages), spec.max_retries))

    def dropped(self, msg_ids: np.ndarray, attempt: int,
                p_msg: np.ndarray) -> np.ndarray:
        """Boolean drop verdicts for ``msg_ids`` on their ``attempt``-th
        try (0-based).  The final attempt always delivers."""
        if attempt >= self.max_retries:
            return np.zeros(msg_ids.shape[0], dtype=bool)
        return self.u[msg_ids, attempt] < p_msg


class _DegradedWireMixin:
    """Overrides the two wire-stage seams of :mod:`repro_torch.core.fabric`
    with degradation-aware service.  Scalar and grouped-scan versions
    perform the same IEEE-754 ops in the same per-link order, so the
    faulty engines inherit the healthy engines' bit-for-bit contract."""

    def __init__(self, cfg: NetConfig, n_vcis: int, n_ranks: int = 2, *,
                 faults: FaultSpec):
        self.faults = faults
        super().__init__(cfg, n_vcis, n_ranks=n_ranks)

    def _wire_service(self, t_start: float, nbytes: float, src: int,
                      dst: int) -> float:
        fac = self.faults.wire_factor(src, dst, t_start)
        return nbytes / (self.cfg.beta * fac)

    def _wire_scan(self, r: np.ndarray, nbytes_s: np.ndarray,
                   src_s: np.ndarray, dst_s: np.ndarray,
                   init: np.ndarray, counts: np.ndarray,
                   offsets: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        # The degradation factor depends on each transfer's *start*
        # time, which the scan only knows step by step — so unlike the
        # healthy engine the service column cannot precompute.  Same
        # recurrence, same op order per link as the scalar seam.
        if not self.faults.degradations:
            return _queue_scan(r, nbytes_s / self.cfg.beta, init, counts,
                               offsets)
        beta = self.cfg.beta
        out = np.empty_like(r)
        cur = init.copy()
        for k in range(int(counts.max()) if len(counts) else 0):
            act = counts > k
            idx = offsets[act] + k
            t0 = np.maximum(r[idx], cur[act])
            fac = self.faults.wire_factor_array(src_s[idx], dst_s[idx], t0)
            t = t0 + nbytes_s[idx] / (beta * fac)
            out[idx] = t
            cur[act] = t
        return out, cur


class FaultyReferenceFabric(_DegradedWireMixin, ReferenceFabric):
    """The scalar oracle with degraded wires — the faulty runs'
    differential-testing reference."""


class FaultyFabric(_DegradedWireMixin, Fabric):
    """The batched engine with degraded wires.  Narrow batches fall back
    to the inherited scalar path, which routes through the same
    ``_wire_service`` seam — both paths stay bit-identical."""


def make_faulty_fabric(engine: str, cfg: NetConfig, n_vcis: int,
                       n_ranks: int, faults: FaultSpec, device="cuda"):
    """Fabric factory for runs with active faults.

    This is the reference's routing, not a fallback that hides the
    device: the JAX package gives its compiled engines the batched NumPy
    fabric under active faults, and the port does the same for its
    ``torch`` and ``cuda`` engines.  Retransmission rounds re-enter the
    queues data-dependently, which defeats the device engines'
    whole-batch layouts, so ``vector``, ``torch`` and ``cuda`` all get
    :class:`FaultyFabric` and ``reference`` gets
    :class:`FaultyReferenceFabric`; ``fault_rate=0`` runs never get here
    and keep their device paths.  ``device`` is resolved first, as the
    healthy factory resolves it, so asking for the card where none is
    present raises here too."""
    resolve_device(device)
    if engine == "reference":
        return FaultyReferenceFabric(cfg, n_vcis, n_ranks=n_ranks,
                                     faults=faults)
    from .simulator import ENGINES  # lazy: avoid import cycle at load
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    return FaultyFabric(cfg, n_vcis, n_ranks=n_ranks, faults=faults)


def expected_retrans_s(msgs: Sequence[Tuple[float, float, float]],
                       spec: FaultSpec, cfg: NetConfig,
                       policy: Optional[RecoveryPolicy] = None) -> float:
    """Closed-form expected retransmission cost of a planned message
    mix — the autotuner's term (the planner adds it to each
    candidate when its scenario carries faults).

    ``msgs`` is ``(nbytes, parts, count)`` triples describing the plan's
    wire messages.  Per message: drop probability ``p = 1-(1-p0)**parts``;
    the expected number of retransmissions under the always-succeeds-at-R
    truncation is the truncated geometric sum ``p + p^2 + ... + p^R``,
    each costing one more pass through injection + NIC + wire.  On top
    of the occupancy, the *critical path* pays the timeout chain: the
    expected backoff delay of the worst message, ``sum_a p^a * timeout *
    backoff^(a-1)``.

    ``policy`` (a :class:`repro_torch.core.recovery.RecoveryPolicy`) makes the
    delay term policy-aware: ``adaptive``/``hedged`` replace the fixed
    timeout with the policy's planning estimate
    (:meth:`~repro_torch.core.recovery.RecoveryPolicy.planning_timeout_s`),
    and ``hedged`` adds the expected wasted-duplicate occupancy.
    ``None`` or ``fixed`` reproduce the pre-policy term bitwise.
    """
    total = 0.0
    worst_delay = 0.0
    for nbytes, parts, count in msgs:
        p = float(spec.message_drop_prob(parts))
        if p <= 0.0:
            continue
        service = cfg.alpha_msg + cfg.alpha_nic + nbytes / cfg.beta
        if policy is not None and policy.kind != "fixed":
            base_s = policy.planning_timeout_s(service, spec.timeout_us)
            dup_s = policy.planning_duplicate_s(count, service)
        else:
            base_s = None  # fixed path: keep the original fp expression
            dup_s = 0.0
        expected_retx = 0.0
        delay = 0.0
        pk = 1.0
        for a in range(1, spec.max_retries + 1):
            pk *= p
            expected_retx += pk
            if base_s is None:
                delay += pk * spec.timeout_us * US * spec.backoff ** (a - 1)
            else:
                delay += pk * base_s * spec.backoff ** (a - 1)
        total += count * expected_retx * service
        if dup_s:
            total += dup_s
        worst_delay = max(worst_delay, delay)
    return total + worst_delay
