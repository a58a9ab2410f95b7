"""Model-driven CommPlan autotuner: the paper's model, used to decide.

The port's copy of the JAX package's ``core/planner.py``, its
arithmetic unchanged term for term, so its predictions, rankings and
choices equal the reference's bit for bit in float64.  Only the
closed-loop validation differs: :func:`simulate_candidate` and
:func:`evaluate_grid` grade the choice on the port's fabric engines
(``engine="cuda"`` and ``device="cuda"`` by default).

The paper *quantifies* when partitioned communication wins (§2.2) and
names two remedies for the small-partition penalty — VCI spreading
(§4.2.2) and partition aggregation (§4.2.3).  This module closes the
loop: given a scenario description (payload, thread count, compute
profile as a :class:`~repro_torch.core.perfmodel.Workload`) and a
hardware :class:`~repro_torch.core.fabric.NetConfig`, it searches the
``(approach, n_partitions, aggr_bytes, n_vcis)`` space with the
**closed-form model** and returns a ranked :class:`PlanChoice` whose
term breakdown explains the pick.

The predictor composes the paper's equations with the fabric's cost
constants; every term carries a name so ``python -m
repro_torch.autotune --explain`` can print the model's reasoning:

  * ``wire``          — bandwidth floor ``B / beta`` (eq 2's body),
  * ``overlap``       — eq (3): the compute ramp ``D`` (eq 8, with eq 9's
    ``gamma_theta``) absorbs up to ``(M - 1)`` message transmissions,
  * ``inject``        — per-message injection on the busiest VCI; with
    more threads than VCIs every message pays the lock bounce
    ``chi_switch`` — the §4.2.1 contention term that VCI spreading
    (§4.2.2) removes,
  * ``pready``/``counter`` — the partitioned path's per-``MPI_Pready``
    atomics and shared-request serialization (§3.2.2) — the
    small-partition penalty that aggregation (§4.2.3) removes,
  * ``protocol``      — eager/bcopy/rendezvous switch costs per message,
  * ``tail``/``sync`` — the last message's latency and the barrier
    around ``MPI_Wait``.

Validation is the *other* half of the design: :func:`evaluate_grid`
simulates both the model's pick and every candidate on the discrete
-event engine and reports the **regret** (auto / grid-best simulated
time).  The ``autotune`` sweep spec (:mod:`repro_torch.experiments.specs`)
pins regret on every scenario of its grid.

The model itself is pure NumPy/math; the simulator is imported only
inside the validation helpers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import commplan
from .fabric import DEFAULT_NET, NetConfig
from .faults import FaultSpec, expected_retrans_s
from .recovery import RecoveryPolicy
from .perfmodel import TPU_ICI_BETA, TPU_PEAK_FLOPS, Workload

# The API variants the planner chooses between (a subset of the
# simulator's SCHEDULES: the RMA and old-AM paths are never optimal in
# the calibrated model, and the paper's remedies target these three).
PLANNER_APPROACHES = ("pt2pt_single", "part", "pt2pt_many")

# Default search axes.  Candidates violating a scenario's bounds
# (n_part > max_parts, n_vcis > max_vcis) are dropped, and equivalent
# candidates (same effective wire plan) are deduplicated.
DEFAULT_THETAS = (1, 2, 4, 8, 16, 32, 64)
DEFAULT_AGGR_BYTES = (0.0, 4096.0, 65536.0, float(1 << 20))
DEFAULT_VCIS = (1, 2, 4, 8, 16, 32)


@dataclass(frozen=True)
class ScenarioDesc:
    """What the application tells the planner about one exchange.

    ``total_bytes`` is the payload of one flow (the paper's buffer);
    ``n_threads`` the producer threads; ``workload`` the compute profile
    (Appendix A) from which the ready ramp and eq-8 delay derive —
    ``None`` means the buffer is ready immediately (no overlap to win).
    ``max_parts``/``max_vcis`` bound the search (hardware VCI count,
    partition bookkeeping limits).  ``faults`` (a
    :class:`~repro_torch.core.faults.FaultSpec`) makes the predictor charge
    every candidate its expected retransmission cost: coarse plans
    retransmit whole buffers on one lost partition, fine plans resend
    one message — the robustness trade-off the paper's model does not
    price but the fault-injection engine measures.  ``policy`` (a
    :class:`~repro_torch.core.recovery.RecoveryPolicy`) makes the retrans
    term policy-aware: the adaptive estimator's converged RTO (or the
    hedge delay plus expected duplicate occupancy) replaces the fixed
    timeout chain; ``None`` keeps the fixed-clock term bitwise.
    """
    total_bytes: float
    n_threads: int = 1
    workload: Optional[Workload] = None
    cfg: NetConfig = DEFAULT_NET
    max_parts: int = 512
    max_vcis: int = 32
    faults: Optional[FaultSpec] = None
    policy: Optional[RecoveryPolicy] = None

    def __post_init__(self):
        if self.total_bytes <= 0:
            raise ValueError("total_bytes must be positive")
        if self.n_threads < 1:
            raise ValueError("n_threads must be >= 1")

    def part_seconds(self, theta: int) -> float:
        """Compute time of one partition on the ready ramp (mu * S_part)."""
        if self.workload is None:
            return 0.0
        return self.workload.mu_s_per_b * self.part_bytes(theta)

    def part_bytes(self, theta: int) -> float:
        return self.total_bytes / (self.n_threads * theta)

    def compute_seconds(self, theta: int) -> float:
        """Total per-thread compute: theta partitions at mu * S_part each.

        Equals ``mu * total_bytes / n_threads`` for every theta — the same
        work repartitioned — so candidate times (which subtract compute)
        compare apples-to-apples.
        """
        return theta * self.part_seconds(theta)

    def ready(self, theta: int) -> Optional[np.ndarray]:
        """The deterministic ready ramp: partition j of every thread is
        ready at ``(j + 1) * mu * S_part`` — :meth:`Workload.sample_ready`
        with ``sigma = 0``.  ``None`` when there is no workload."""
        if self.workload is None:
            return None
        c = self.part_seconds(theta)
        return np.tile(np.arange(1, theta + 1, dtype=float) * c,
                       (self.n_threads, 1))


@dataclass(frozen=True)
class Candidate:
    """One point of the search space, pre-canonicalization."""
    approach: str
    theta: int
    aggr_bytes: float
    n_vcis: int


@dataclass(frozen=True)
class PlanChoice:
    """A ranked plan with its predicted time and term breakdown."""
    approach: str
    theta: int
    aggr_bytes: float
    n_vcis: int
    predicted_s: float
    terms: Tuple[Tuple[str, float], ...] = ()

    @property
    def predicted_us(self) -> float:
        return self.predicted_s / 1e-6

    def n_partitions(self, desc: ScenarioDesc) -> int:
        return desc.n_threads * self.theta

    @property
    def params(self) -> Dict[str, object]:
        """The simulator kwargs this choice corresponds to."""
        return {"approach": self.approach, "theta": self.theta,
                "aggr_bytes": self.aggr_bytes, "n_vcis": self.n_vcis}


# ---------------------------------------------------------------------------
# The closed-form predictor
# ---------------------------------------------------------------------------

def _n_messages(desc: ScenarioDesc, theta: int, aggr_bytes: float) -> int:
    """Wire messages of the part approach's CommPlan (gcd is n_part)."""
    n_part = desc.n_threads * theta
    return commplan.aggregate_message_count(
        n_part, desc.part_bytes(theta), aggr_bytes)


def _copy_cost(cfg: NetConfig, nbytes: float) -> float:
    """The bcopy intermediate copy paid at injection (1 KiB < S <= 8 KiB)."""
    if cfg.eager_max < nbytes <= cfg.bcopy_max:
        return nbytes / cfg.beta_copy
    return 0.0


def _streak_cost(cfg: NetConfig, streak: float) -> float:
    """Average per-message VCI injection cost given the owner-streak
    length: a streak of ``streak`` same-thread messages pays one lock
    bounce (``chi_switch``) then ``streak - 1`` cheap injections."""
    if streak <= 1.0:
        return cfg.chi_switch
    return (cfg.chi_switch + (streak - 1.0) * cfg.alpha_msg) / streak


def _tail_latency(cfg: NetConfig, nbytes: float) -> float:
    """The last message's latencies *beyond* its stage occupancies
    (which the leader/drain envelopes already count): rendezvous
    round trip, wire latency, receiver completion."""
    rendezvous = 2.0 * cfg.alpha_wire if nbytes > cfg.bcopy_max else 0.0
    return rendezvous + cfg.alpha_wire + cfg.alpha_recv


def _pipeline(stages: Sequence[Tuple[float, float]]) -> float:
    """Makespan of a uniform batch through serial stages: ``(unit,
    work)`` per stage.  The bottleneck stage works back-to-back; every
    other stage contributes one message's fill/drain latency."""
    works = [w for _, w in stages]
    b = works.index(max(works))
    return works[b] + sum(u for i, (u, _) in enumerate(stages) if i != b)


def _drain_term(cands: Dict[str, float]) -> Tuple[str, float]:
    """The drain phase's bottleneck: its stages pipeline, so the slowest
    serial resource sets the pace.  Returns (name, seconds)."""
    name = max(cands, key=lambda k: cands[k])
    return name, cands[name]


def _predict_healthy(desc: ScenarioDesc, cand: Candidate) -> PlanChoice:
    """Closed-form predicted time (seconds, compute excluded) of running
    ``cand`` on the scenario, with a named additive term breakdown
    (``sum(t for _, t in choice.terms) == choice.predicted_s``).

    The model mirrors the engine's single-flow semantics in two phases:

    * **leader** — the first thread's messages ride the compute ramp
      (eq 3's overlap: up to its whole compute ``C = mu * B / T``, the
      eq-8 delay of the ramp, is absorbed); what the bottleneck stage
      cannot hide surfaces as ``ramp_spill``;
    * **drain** — the engine transmits a flow's messages in canonical
      thread-major order, so the remaining ``(T-1)/T`` of the payload
      serializes after the ramp on the slowest resource: the wire
      (``B/beta``), the NIC, the VCI banks (with §4.2.1's ``chi_switch``
      when owners alternate — the term VCI spreading removes), or the
      partitioned path's Pready/counter chains (§3.2.2 — the terms
      aggregation removes);
    * **tail** — the last message's un-overlappable latencies, and
      ``sync`` — barriers around the exchange.
    """
    cfg, T = desc.cfg, desc.n_threads
    theta = cand.theta
    start = cfg.barrier(T)

    if cand.approach == "pt2pt_single":
        # Bulk: barrier until every thread finished, then one message;
        # exact (the one case with no queueing at all).
        B = desc.total_bytes
        inject = cfg.alpha_first + _copy_cost(cfg, B)
        path = inject + cfg.alpha_nic + B / cfg.beta \
            + _tail_latency(cfg, B)
        terms = (("sync", start + cfg.barrier(T)),
                 ("wire", B / cfg.beta),
                 ("tail", path - B / cfg.beta))
        return PlanChoice("pt2pt_single", theta, cand.aggr_bytes,
                          cand.n_vcis, start + cfg.barrier(T) + path, terms)

    c = desc.part_seconds(theta)        # ready-ramp step per partition
    compute = desc.compute_seconds(theta)
    n_part = T * theta

    if cand.approach == "pt2pt_many":
        V = max(1, min(cand.n_vcis, T))
        threads_per_vci = math.ceil(T / V)
        S = desc.part_bytes(theta)
        serv = cfg.alpha_msg + _copy_cost(cfg, S)
        w1 = serv + cfg.alpha_nic + S / cfg.beta
        # Leader phase: thread 0's theta messages on the ramp.
        leader_work = _pipeline([(serv, theta * serv),
                                 (cfg.alpha_nic, theta * cfg.alpha_nic),
                                 (S / cfg.beta, theta * S / cfg.beta)])
        leader_finish = max(compute + w1, c + leader_work)
        spill = leader_finish - compute
        # Drain phase: the other threads' messages, already ready, are
        # transmitted thread-block by thread-block.  Each VCI's *first*
        # block rides the ramp alongside the leader (V parallel
        # leaders), but its remaining ``threads_per_vci - 1`` blocks
        # serialize after it — one lock bounce per block — and the last
        # block's payload still has to cross the wire afterwards.
        vci_block = cfg.chi_switch + (theta - 1) * cfg.alpha_msg \
            + theta * _copy_cost(cfg, S)
        vci_drain = (threads_per_vci - 1) * vci_block
        if vci_drain > 0.0:
            vci_drain += theta * S / cfg.beta
        drain_name, drain = _drain_term({
            "wire": (T - 1) * theta * S / cfg.beta,
            "nic": (T - 1) * theta * cfg.alpha_nic,
            "vci": vci_drain,
        })
        tail = _tail_latency(cfg, S)
        terms = (("sync", start),
                 ("ramp_spill", spill),
                 (f"drain[{drain_name}]", drain),
                 ("tail", tail))
        return PlanChoice("pt2pt_many", theta, cand.aggr_bytes, V,
                          start + spill + drain + tail, terms)

    if cand.approach != "part":
        raise ValueError(f"unknown approach {cand.approach!r};"
                         f" one of {PLANNER_APPROACHES}")

    # --- the partitioned path ---
    M = _n_messages(desc, theta, cand.aggr_bytes)
    V = max(1, min(cand.n_vcis, M))
    group = math.ceil(n_part / M)        # partitions per wire message
    msg_bytes = desc.total_bytes / M
    serv = cfg.alpha_msg + _copy_cost(cfg, msg_bytes)
    w1 = serv + cfg.alpha_nic + msg_bytes / cfg.beta
    # Leader phase: thread 0's messages complete every ``group``-th ramp
    # step and spread over the V VCIs; aggregating beyond one thread's
    # buffer (group > theta) leaves no leader at all — every message
    # waits for the full ramp (aggregation kills the overlap, eq 5's
    # regime seen from the other side).
    leader_msgs = theta // group if group <= theta else 0
    if T == 1:
        leader_msgs = M
    if leader_msgs > 0:
        leader_work = _pipeline([
            (serv, math.ceil(leader_msgs / V) * serv),
            (cfg.alpha_nic, leader_msgs * cfg.alpha_nic),
            (msg_bytes / cfg.beta, leader_msgs * msg_bytes / cfg.beta)])
        leader_finish = max(compute + w1,
                            group * c + cfg.alpha_atomic + leader_work)
    else:
        leader_finish = compute + cfg.alpha_atomic + w1
    spill = leader_finish - compute
    drain_msgs = M - leader_msgs
    # Serial chains of the partitioned path (§3.2.2): one cache-line
    # bounce per Pready across the drain partitions, one shared-request
    # update per drain message — both vanish at T == 1.
    w_pready = (T - 1) * theta * cfg.alpha_bounce if T > 1 else 0.0
    w_counter = drain_msgs * cfg.alpha_counter if T > 1 else 0.0
    # VCI streaks: the owner thread changes every theta/group messages.
    streak = max(1.0, (theta / group) / V) if group <= theta else 1.0
    serv2 = _streak_cost(cfg, streak) + _copy_cost(cfg, msg_bytes) \
        if T > 1 else serv
    drain_name, drain = _drain_term({
        "wire": drain_msgs * msg_bytes / cfg.beta,
        "nic": drain_msgs * cfg.alpha_nic,
        "vci": (drain_msgs / V) * serv2,
        "pready": w_pready,
        "counter": w_counter,
    })
    tail = _tail_latency(cfg, msg_bytes) + cfg.barrier(T)
    terms = (("sync", start + cfg.barrier(T)),
             ("ramp_spill", spill),
             (f"drain[{drain_name}]", drain),
             ("tail", tail - cfg.barrier(T)))
    return PlanChoice("part", theta, cand.aggr_bytes, V,
                      start + spill + drain + tail, terms)


def _candidate_messages(desc: ScenarioDesc,
                        cand: Candidate) -> List[Tuple[float, int, int]]:
    """The candidate's wire plan as ``(nbytes, partitions, count)``
    triples — the retransmission unit each approach exposes to the
    fault model.  pt2pt_single stakes the whole buffer (all ``T *
    theta`` partitions) on one message; pt2pt_many risks one partition
    per message; an aggregated part plan risks ``group`` partitions per
    wire message."""
    T, theta = desc.n_threads, cand.theta
    if cand.approach == "pt2pt_single":
        return [(desc.total_bytes, T * theta, 1)]
    if cand.approach == "pt2pt_many":
        return [(desc.part_bytes(theta), 1, T * theta)]
    M = _n_messages(desc, theta, cand.aggr_bytes)
    group = math.ceil(T * theta / M)
    return [(desc.total_bytes / M, group, M)]


def predict(desc: ScenarioDesc, cand: Candidate) -> PlanChoice:
    """:func:`_predict_healthy` plus, when ``desc.faults`` enables
    partition drops, a named ``retrans`` term: the expected extra
    occupancy and timeout delay of resending dropped messages
    (:func:`repro_torch.core.faults.expected_retrans_s`).  With faults absent
    (or degradation-only — windows shift all candidates alike) the
    healthy prediction is returned unchanged, so no-fault autotune
    records are untouched.  ``desc.policy`` swaps the term's recovery
    clock (:mod:`repro_torch.core.recovery`); ``None`` keeps the fixed one."""
    choice = _predict_healthy(desc, cand)
    f = desc.faults
    if f is None or not f.drops_enabled:
        return choice
    extra = expected_retrans_s(_candidate_messages(desc, cand), f, desc.cfg,
                               policy=desc.policy)
    return PlanChoice(choice.approach, choice.theta, choice.aggr_bytes,
                      choice.n_vcis, choice.predicted_s + extra,
                      choice.terms + (("retrans", extra),))


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------

def _signature(desc: ScenarioDesc, cand: Candidate) -> tuple:
    """Candidates mapping to the same effective wire plan simulate (and
    predict) identically; keep one representative per signature.  Under
    partition drops a pt2pt_single message's loss probability depends on
    how many partitions it carries, so theta joins its signature."""
    if cand.approach == "pt2pt_single":
        if desc.faults is not None and desc.faults.drops_enabled:
            return ("pt2pt_single", cand.theta)
        return ("pt2pt_single",)
    if cand.approach == "pt2pt_many":
        return ("pt2pt_many", cand.theta, min(cand.n_vcis, desc.n_threads))
    M = _n_messages(desc, cand.theta, cand.aggr_bytes)
    return ("part", cand.theta, M, min(cand.n_vcis, M))


def candidate_grid(desc: ScenarioDesc, *,
                   thetas: Sequence[int] = DEFAULT_THETAS,
                   aggr_bytes: Sequence[float] = DEFAULT_AGGR_BYTES,
                   vcis: Sequence[int] = DEFAULT_VCIS,
                   approaches: Sequence[str] = PLANNER_APPROACHES
                   ) -> List[Candidate]:
    """The deduplicated search space for one scenario.

    ``approaches`` restricts the search (an inherently partitioned API
    like :meth:`PartitionedRequest.auto` passes ``("part",)``).  When
    the partitioned approach is searched, the hand-picked *default
    plan* (``part``, theta = 8-or-largest-legal, no aggregation, one
    VCI — the constants every pre-planner sweep spec used) is always
    present, so :func:`choose_plan` can never predict worse than it.
    """
    unknown = set(approaches) - set(PLANNER_APPROACHES)
    if unknown or not approaches:
        raise ValueError(f"approaches must be a non-empty subset of"
                         f" {PLANNER_APPROACHES}, got {approaches!r}")
    out: List[Candidate] = []
    seen = set()

    def add(cand: Candidate):
        if cand.approach not in approaches:
            return
        if desc.n_threads * cand.theta > desc.max_parts:
            return
        if cand.n_vcis > desc.max_vcis:
            return
        sig = _signature(desc, cand)
        if sig not in seen:
            seen.add(sig)
            out.append(cand)

    add(default_candidate(desc))
    add(Candidate("pt2pt_single", 1, 0.0, 1))
    for theta in thetas:
        for v in vcis:
            add(Candidate("pt2pt_many", theta, 0.0, v))
            for a in aggr_bytes:
                add(Candidate("part", theta, a, v))
    if not out:
        raise ValueError("no candidate satisfies the scenario bounds"
                         f" (max_parts={desc.max_parts},"
                         f" max_vcis={desc.max_vcis})")
    return out


def default_candidate(desc: ScenarioDesc) -> Candidate:
    """The hand-picked constants every pre-planner sweep spec used:
    partitioned, theta = 8 (or the largest legal), no aggregation, one
    VCI — the property tests compare the auto choice against this."""
    theta = 8
    while desc.n_threads * theta > desc.max_parts and theta > 1:
        theta //= 2
    return Candidate("part", theta, 0.0, 1)


def rank_plans(desc: ScenarioDesc, *,
               thetas: Sequence[int] = DEFAULT_THETAS,
               aggr_bytes: Sequence[float] = DEFAULT_AGGR_BYTES,
               vcis: Sequence[int] = DEFAULT_VCIS,
               approaches: Sequence[str] = PLANNER_APPROACHES
               ) -> List[PlanChoice]:
    """All candidates ranked by predicted time (stable: grid order
    breaks ties, so the choice is deterministic)."""
    cands = candidate_grid(desc, thetas=thetas, aggr_bytes=aggr_bytes,
                           vcis=vcis, approaches=approaches)
    choices = [predict(desc, c) for c in cands]
    return sorted(choices, key=lambda ch: ch.predicted_s)


def choose_plan(desc: ScenarioDesc, **kw) -> PlanChoice:
    """The model's pick: the candidate with the lowest predicted time."""
    return rank_plans(desc, **kw)[0]


def explain(desc: ScenarioDesc, choice: PlanChoice) -> str:
    """Human-readable term-by-term breakdown of one choice."""
    lines = [f"{choice.approach}: theta={choice.theta}"
             f" (n_partitions={choice.n_partitions(desc)})"
             f" aggr_bytes={choice.aggr_bytes:g} n_vcis={choice.n_vcis}"
             f" -> predicted {choice.predicted_us:.2f} us"]
    for name, seconds in choice.terms:
        lines.append(f"    {name:<8s} {seconds / 1e-6:+10.2f} us")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# The gradient-sync scenario
# ---------------------------------------------------------------------------

# The reference's NetConfig for a TPU slice: per-link ICI bandwidth
# instead of HDR IB; the latency-side constants keep their
# MPICH-calibrated values as stand-ins for the per-collective launch
# overheads.  The port keeps it as the default of the training side's
# sync planning so that its choices equal the reference's; it is a
# model input, not a description of the GPU.
TPU_NET = NetConfig(beta=TPU_ICI_BETA)


def training_workload(flops_per_grad_byte: float = 8192.0, *,
                      peak_flops: float = TPU_PEAK_FLOPS,
                      eps: float = 0.05, delta: float = 0.1) -> Workload:
    """A Workload whose ``mu`` is the backward pass's compute seconds
    per gradient byte.

    For a transformer, backward FLOPs ~ 4 P t (P params, t tokens per
    device per step) against ~2 P gradient bytes in bf16, so
    ``flops_per_grad_byte ~ 2 t`` (default: t = 4096).  ``ci = 1`` and
    ``freq_hz = peak_flops / 8`` make :attr:`Workload.mu_s_per_b` come
    out exactly ``flops_per_grad_byte / peak_flops`` seconds per byte —
    the ramp at which layer gradients become ready during backward.
    """
    return Workload(ai=flops_per_grad_byte, ci=1.0, eps=eps, delta=delta,
                    freq_hz=peak_flops / 8.0)


def gradient_desc(total_bytes: float, *, workload: Optional[Workload] = None,
                  cfg: NetConfig = TPU_NET,
                  max_channels: int = 8) -> ScenarioDesc:
    """ScenarioDesc for one data-parallel gradient synchronization."""
    return ScenarioDesc(total_bytes=float(total_bytes), n_threads=1,
                        workload=workload or training_workload(),
                        cfg=cfg, max_vcis=max_channels)


@dataclass(frozen=True)
class GridEval:
    """The closed loop: the model's pick vs the simulated grid-best."""
    choice: PlanChoice
    auto_time_s: float          # simulated time of the model's pick
    auto_messages: int
    best: PlanChoice            # grid-best candidate (simulated)
    best_time_s: float
    n_candidates: int

    @property
    def regret(self) -> float:
        """auto / best simulated time; 1.0 = the model picked the best."""
        return self.auto_time_s / self.best_time_s


def simulate_candidate(desc: ScenarioDesc, cand: Candidate,
                       engine: str = "cuda",
                       device="cuda") -> Tuple[float, int]:
    """One candidate on the discrete-event engine; returns (time_s,
    n_messages).  The simulator import is deferred so the planner stays
    model-only on the import path."""
    from . import simulator as sim
    r = sim.simulate(cand.approach, n_threads=desc.n_threads,
                     theta=cand.theta,
                     part_bytes=desc.part_bytes(cand.theta),
                     ready=desc.ready(cand.theta),
                     n_vcis=cand.n_vcis, aggr_bytes=cand.aggr_bytes,
                     cfg=desc.cfg, engine=engine, device=device)
    return r.time_s, r.n_messages


def evaluate_grid(desc: ScenarioDesc, engine: str = "cuda", device="cuda",
                  **kw) -> GridEval:
    """Simulate the model's pick and every candidate; report regret.

    This is the paper's "quantify, then exploit" loop run in reverse:
    the model decided, the simulator grades the decision.  ``device``
    is resolved before anything runs, so asking for the card where none
    is present raises even though one flow stays on the scalar path.
    """
    from .fabric_torch import resolve_device
    device = resolve_device(device)
    ranked = rank_plans(desc, **kw)
    choice = ranked[0]
    by_key = {(c.approach, c.theta, c.aggr_bytes, c.n_vcis): c
              for c in ranked}
    choice_key = (choice.approach, choice.theta, choice.aggr_bytes,
                  choice.n_vcis)
    auto_time = auto_msgs = None
    best_key, best_time = None, math.inf
    for key in by_key:
        t, m = simulate_candidate(desc, Candidate(*key), engine, device)
        if key == choice_key:
            auto_time, auto_msgs = t, m
        if t < best_time:
            best_key, best_time = key, t
    best = by_key[best_key]
    return GridEval(choice=choice, auto_time_s=auto_time,
                    auto_messages=auto_msgs, best=best,
                    best_time_s=best_time, n_candidates=len(ranked))
