"""Recovery policies: when does a dropped partition get retransmitted?

The port's copy of the JAX package's ``core/recovery.py``, unchanged
in its arithmetic.

The fault layer's baseline recovers on a *fixed* clock — every dropped
message re-enters the live queues ``timeout_us * backoff**attempt``
after its would-be delivery, no matter what the fabric's actual
round-trip looks like.  A mistuned timeout either stalls the tail (timeout far above the
real service time) or floods the queues with spurious duplicates
(timeout below it).  This module makes the recovery clock a *policy*:

* ``fixed`` — today's behavior, bit-for-bit.  The retransmission
  re-entry time is exactly ``t_arrive + timeout_us * US * backoff **
  attempt``, the same floating-point expression the simulator inlined
  before this layer existed.  It is the default everywhere.
* ``adaptive`` — a Jacobson/Karels estimator per (src, dst) link: the
  smoothed RTT and its mean deviation are EWMA-updated from observed
  wire completions (RFC 6298 gains), the RTO is ``srtt +
  rttvar_mult * rttvar`` clamped to ``[rto_min_us, rto_max_us]``, and
  Karn's rule skips samples from retransmitted messages (their
  completion time is ambiguous).  Links without samples fall back to
  the spec's fixed timeout.
* ``hedged`` — speculative duplicates: every message arms a hedge
  timer at submission, set to a tail quantile of the latencies observed
  so far (times ``hedge_mult``, clamped to ``[rto_min_us,
  timeout_us]``).  A message that delivers *after* its hedge fired has
  sent a wasted duplicate — the duplicate delivery is suppressed at
  the receiver and the wasted bytes are accounted
  (``duplicate_bytes``); a message that was dropped re-enters at its
  hedge time, which is what cuts the tail: the retransmit launches
  from the *send* clock instead of waiting out a full timeout past the
  would-be delivery.  Conservation: ``n_hedges == n_suppressed +
  n_retransmits_hedge`` — every armed hedge either raced a delivery
  (suppressed) or became the retransmission.

All state lives in a per-run :class:`RecoveryState` (``policy.fresh
(spec)``); the policy object itself is an immutable spec, safe to share
across runs and sweeps.  Estimator updates consume messages in the
simulator's deterministic merge order (stable argsort on ready time),
so faulty runs stay exactly reproducible and engine-independent: the
policies only ever read arrival times that the engines already agree
on bit-for-bit.

The module is a numpy-only leaf (no imports from the fault or fabric
layers) so ``core.faults`` and ``runtime.fault_tolerance`` can both
source the shared retry defaults below without an import cycle.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

US = 1e-6

# Shared retry/backoff defaults.  Single source of truth: FaultSpec
# (core.faults) and the runtime's checkpoint/heartbeat retry loop
# (runtime.fault_tolerance) both read these instead of hardcoding their
# own copies.
DEFAULT_TIMEOUT_US = 50.0
DEFAULT_BACKOFF = 2.0
DEFAULT_MAX_RETRIES = 8

POLICIES = ("fixed", "adaptive", "hedged")


@dataclass(frozen=True)
class RecoveryPolicy:
    """Immutable recovery-policy spec; ``fresh()`` mints per-run state.

    ``kind`` selects the policy; the remaining fields parameterize the
    estimators and are ignored by ``fixed``:

    * ``rto_min_us`` / ``rto_max_us`` — clamps on the adaptive RTO and
      the hedge delay (floor guards against a degenerate zero-variance
      estimate retransmitting instantly; ceiling bounds how badly a
      poisoned estimate can stall the tail).
    * ``srtt_gain`` / ``rttvar_gain`` / ``rttvar_mult`` — RFC 6298
      constants (g=1/8, h=1/4, K=4).
    * ``hedge_quantile`` / ``hedge_mult`` — the hedge timer is
      ``quantile(observed latencies) * hedge_mult``: q=0.95 with
      mult=2 hedges only the worst ~5% of deliveries, keeping the
      wasted duplicate bytes bounded.
    """
    kind: str = "fixed"
    rto_min_us: float = 5.0
    rto_max_us: float = 400.0
    srtt_gain: float = 0.125
    rttvar_gain: float = 0.25
    rttvar_mult: float = 4.0
    hedge_quantile: float = 0.95
    hedge_mult: float = 2.0

    def __post_init__(self):
        if self.kind not in POLICIES:
            raise ValueError(
                f"kind must be one of {POLICIES}, got {self.kind!r}")
        if not (self.rto_min_us > 0.0):
            raise ValueError(
                f"rto_min_us must be positive, got {self.rto_min_us}")
        if self.rto_max_us < self.rto_min_us:
            raise ValueError(
                f"rto_max_us ({self.rto_max_us}) must be >= rto_min_us "
                f"({self.rto_min_us})")
        for name in ("srtt_gain", "rttvar_gain"):
            g = getattr(self, name)
            if not (0.0 < g <= 1.0):
                raise ValueError(f"{name} must be in (0, 1], got {g}")
        if not (self.rttvar_mult > 0.0):
            raise ValueError(
                f"rttvar_mult must be positive, got {self.rttvar_mult}")
        if not (0.0 < self.hedge_quantile < 1.0):
            raise ValueError(
                f"hedge_quantile must be in (0, 1), got "
                f"{self.hedge_quantile}")
        if not (self.hedge_mult > 0.0):
            raise ValueError(
                f"hedge_mult must be positive, got {self.hedge_mult}")

    def fresh(self, timeout_us: float, backoff: float) -> "RecoveryState":
        """Per-run mutable state, parameterized by the FaultSpec's fixed
        timeout (the fallback clock) and backoff factor."""
        cls = {"fixed": _FixedState, "adaptive": _AdaptiveState,
               "hedged": _HedgedState}[self.kind]
        return cls(self, timeout_us, backoff)

    # -- planner hooks (closed-form model; no observations available) --

    def planning_timeout_s(self, service_s: float, timeout_us: float) -> float:
        """The per-attempt recovery delay the closed-form model should
        charge (:func:`repro_torch.core.faults.expected_retrans_s`).

        ``fixed`` charges the spec's timeout, reproducing the pre-policy
        term bitwise.  ``adaptive`` charges the steady-state Jacobson
        estimate: with near-deterministic service the RTO converges to
        roughly the service time plus the variance guard band — modeled
        as ``2 * service`` under the policy's clamps.  ``hedged``
        charges the hedge delay, ``hedge_mult * service`` clamped to
        the floor and the spec timeout (the hedge never waits longer
        than the fixed clock would have).
        """
        if self.kind == "fixed":
            return timeout_us * US
        if self.kind == "adaptive":
            est = max(self.rto_min_us * US, 2.0 * service_s)
            return min(est, self.rto_max_us * US)
        est = max(self.rto_min_us * US, self.hedge_mult * service_s)
        return min(est, timeout_us * US)

    def planning_duplicate_s(self, count: float, service_s: float) -> float:
        """Expected wasted-duplicate occupancy per candidate: ``hedged``
        speculatively re-sends the slowest ``1 - hedge_quantile``
        fraction of deliveries; the other policies never duplicate."""
        if self.kind != "hedged":
            return 0.0
        return count * (1.0 - self.hedge_quantile) * service_s


def make_policy(policy: Union[None, str, RecoveryPolicy]) -> RecoveryPolicy:
    """Resolve ``None`` / a name / an instance to a policy (default:
    ``fixed``, i.e. the pre-policy behavior)."""
    if policy is None:
        return RecoveryPolicy()
    if isinstance(policy, RecoveryPolicy):
        return policy
    if isinstance(policy, str):
        return RecoveryPolicy(kind=policy)
    raise TypeError(
        f"policy must be None, a policy name {POLICIES}, or a "
        f"RecoveryPolicy, got {type(policy).__name__}")


class RecoveryState:
    """Per-run policy state: observes wire completions, schedules
    retransmissions, accounts hedged duplicates.

    The simulator calls, per retransmission round and in its
    deterministic merge order:

    1. ``observe(src, dst, t_sub, t_arr, nbytes, attempt, delivered)``
       with *every* message of the round — delivered ones feed the
       estimators (subject to Karn's rule), and the hedged policy does
       its duplicate accounting here;
    2. ``retrans_times(src, dst, t_sub, t_arr, attempt)`` with the
       *dropped* subset — returns each message's re-entry time.

    Counters (hedged only; zero elsewhere): ``n_hedges`` timers fired,
    ``n_suppressed`` duplicates suppressed at the receiver,
    ``duplicate_bytes`` wasted payload.
    """

    def __init__(self, policy: RecoveryPolicy, timeout_us: float,
                 backoff: float):
        self.policy = policy
        self.timeout_us = float(timeout_us)
        self.backoff = float(backoff)
        self.n_hedges = 0
        self.n_suppressed = 0
        self.duplicate_bytes = 0.0

    def observe(self, src: np.ndarray, dst: np.ndarray, t_sub: np.ndarray,
                t_arr: np.ndarray, nbytes: np.ndarray, attempt: int,
                delivered: np.ndarray) -> None:
        pass

    def retrans_times(self, src: np.ndarray, dst: np.ndarray,
                      t_sub: np.ndarray, t_arr: np.ndarray,
                      attempt: int) -> np.ndarray:
        raise NotImplementedError


class _FixedState(RecoveryState):
    """Pre-policy behavior, bit-for-bit: the re-entry expression below
    is character-for-character the one the simulator inlined before the
    policy layer, so ``policy="fixed"`` (and ``policy=None``) cannot
    perturb a single ULP of any committed baseline."""

    def retrans_times(self, src, dst, t_sub, t_arr, attempt):
        return t_arr + self.timeout_us * US * self.backoff ** attempt


class _AdaptiveState(RecoveryState):
    """Jacobson/Karels per-link RTO (RFC 6298).

    First sample on a link: ``srtt = rtt, rttvar = rtt / 2``.  After:
    ``rttvar = (1-h)*rttvar + h*|srtt - rtt|`` then ``srtt =
    (1-g)*srtt + g*rtt`` (deviation updated against the *old* srtt).
    RTO = ``clamp(srtt + K*rttvar, rto_min, rto_max)``; unseen links
    fall back to the spec's fixed timeout.  Karn's rule: samples with
    ``attempt > 0`` are retransmissions — their measured completion
    cannot be attributed to a specific send, so they never enter the
    estimator.  The retransmission anchor stays the would-be delivery
    (same as ``fixed``): by the time the timer fires, the round's
    deliveries have ACKed, so the estimator consulted is the
    post-observation one.
    """

    def __init__(self, policy, timeout_us, backoff):
        super().__init__(policy, timeout_us, backoff)
        # link -> [srtt_s, rttvar_s]
        self._links: Dict[Tuple[int, int], List[float]] = {}

    def observe(self, src, dst, t_sub, t_arr, nbytes, attempt, delivered):
        if attempt > 0:  # Karn's rule: retransmitted samples are ambiguous
            return
        p = self.policy
        links = self._links
        idx = np.flatnonzero(delivered)
        rtts = t_arr[idx] - t_sub[idx]
        s_arr = src[idx]
        d_arr = dst[idx]
        for i in range(idx.shape[0]):
            key = (int(s_arr[i]), int(d_arr[i]))
            rtt = float(rtts[i])
            est = links.get(key)
            if est is None:
                links[key] = [rtt, rtt / 2.0]
            else:
                srtt, rttvar = est
                est[1] = ((1.0 - p.rttvar_gain) * rttvar
                          + p.rttvar_gain * abs(srtt - rtt))
                est[0] = (1.0 - p.srtt_gain) * srtt + p.srtt_gain * rtt

    def rto_s(self, src: int, dst: int) -> float:
        est = self._links.get((src, dst))
        if est is None:
            return self.timeout_us * US
        p = self.policy
        rto = est[0] + p.rttvar_mult * est[1]
        return min(max(rto, p.rto_min_us * US), p.rto_max_us * US)

    def retrans_times(self, src, dst, t_sub, t_arr, attempt):
        rto = np.array([self.rto_s(int(s), int(d))
                        for s, d in zip(src, dst)])
        return t_arr + rto * self.backoff ** attempt


class _HedgedState(RecoveryState):
    """Quantile hedge timers with duplicate suppression.

    The hedge delay is an order-statistic quantile (the same
    convention as the serving tail metrics: smallest sample at or
    above rank ``q * (n-1)``) of every attempt-0 delivery latency
    observed so far, times ``hedge_mult``, clamped to ``[rto_min,
    timeout]``.  Timers are armed at *submission* with the estimate
    current at round start (``observe`` snapshots the delay before
    folding in the round's own samples — a sender cannot set a timer
    with latencies it has not seen yet), so within one round the
    accounting and the re-entry schedule use the same delay.
    """

    def __init__(self, policy, timeout_us, backoff):
        super().__init__(policy, timeout_us, backoff)
        self._samples: List[float] = []
        self._snap_delay = self._delay_s()

    def _delay_s(self) -> float:
        p = self.policy
        if not self._samples:
            return self.timeout_us * US
        s = np.sort(np.asarray(self._samples))
        n = s.shape[0]
        k = min(n - 1, int(np.ceil(p.hedge_quantile * (n - 1))))
        est = float(s[k]) * p.hedge_mult
        return min(max(est, p.rto_min_us * US), self.timeout_us * US)

    def observe(self, src, dst, t_sub, t_arr, nbytes, attempt, delivered):
        delay = self._delay_s()
        self._snap_delay = delay
        lat = t_arr - t_sub
        fire = delay * self.backoff ** attempt
        # delivered but slower than the hedge timer: the duplicate went
        # out and lost the race — suppressed at the receiver, bytes wasted
        raced = delivered & (lat > fire)
        n_raced = int(np.count_nonzero(raced))
        self.n_hedges += n_raced + int(np.count_nonzero(~delivered))
        self.n_suppressed += n_raced
        self.duplicate_bytes += float(nbytes[raced].sum())
        if attempt == 0:  # Karn's rule, as in the adaptive estimator
            self._samples.extend(
                (t_arr[delivered] - t_sub[delivered]).tolist())

    def retrans_times(self, src, dst, t_sub, t_arr, attempt):
        return t_sub + self._snap_delay * self.backoff ** attempt
