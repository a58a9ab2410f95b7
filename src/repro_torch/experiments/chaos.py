"""Chaos campaigns: randomized fault specs, hard invariants.

The port's copy of the JAX package's ``experiments/chaos.py``.  The
committed sweeps pin a handful of fault points exactly; this harness
pins the *rules* on hundreds of sampled ones.  Each campaign draws a
randomized :class:`~repro_torch.core.faults.FaultSpec` (drop
probability, mistuned timeout, backoff, retry budget, optional
degradation window), a recovery policy, and a scenario — a stencil
exchange (:func:`~repro_torch.core.simulator.simulate_faulty`) or an
open-loop serving trace (:func:`~repro_torch.core.simulator
.simulate_serving`, sometimes with overload shedding) — runs it on the
chosen engine (``cuda`` by default; the reference compares ``vector``)
*and* on the ``reference`` engine, and asserts the invariants that must
hold for every legal input:

* **engine agreement** — the engine == reference bit-for-bit (times,
  counters, per-message/per-request arrays);
* **message conservation** — wire messages == deliveries +
  retransmissions; under the hedged policy, hedges == suppressions +
  retransmissions (every armed hedge either raced a delivery or became
  the retransmit); requests == completions + shed;
* **monotone clocks** — no message arrives before it was submitted;
* **final-attempt delivery** — retransmission rounds are bounded by
  ``max_retries + 1`` and a faulty run never beats its clean twin;
* **determinism** — a sampled subset of campaigns is re-run and must
  reproduce exactly.

Everything derives from ``SeedSequence([seed, campaign])`` — a failing
campaign is replayable from its index alone, and campaign ``i`` draws
the same scenario as the reference harness's campaign ``i``.  Every
campaign samples a drop probability of at least 0.005, so its faulty
runs take the NumPy faulty fabric on every engine but ``reference``, as
in the JAX package: the harness holds the drivers' host logic on the
chosen engine, not the fabric kernel.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..core import simulator as sim
from ..core.faults import FaultSpec, LinkDegrade
from ..core.recovery import POLICIES

_APPROACHES = ("part", "pt2pt_many", "pt2pt_single")
_DIMS = ((2, 2), (3, 2), (4, 2), (2, 2, 2))
_FACE_BYTES = (8192.0, 32768.0, 131072.0)

#: Every how many campaigns the determinism re-run fires (campaign
#: indices divisible by this re-run the chosen engine and require exact
#: reproduction).
RERUN_EVERY = 8


def _sample_spec(rng: np.random.Generator) -> FaultSpec:
    degradations = ()
    if rng.random() < 0.3:
        t0 = float(rng.uniform(0.0, 50.0))
        degradations = (LinkDegrade(
            t_start_us=t0, t_end_us=t0 + float(rng.uniform(10.0, 100.0)),
            factor=float(rng.uniform(0.2, 0.9))),)
    return FaultSpec(
        drop_prob=float(rng.uniform(0.005, 0.25)),
        timeout_us=float(rng.uniform(5.0, 200.0)),
        backoff=float(rng.uniform(1.1, 3.0)),
        max_retries=int(rng.integers(2, 9)),
        degradations=degradations,
        seed=int(rng.integers(0, 2 ** 31)))


def _sample_stencil(rng: np.random.Generator) -> Dict[str, Any]:
    dims = _DIMS[rng.integers(len(_DIMS))]
    return dict(
        approach=_APPROACHES[rng.integers(len(_APPROACHES))],
        dims=dims,
        theta=int(2 ** rng.integers(1, 4)),
        face_bytes=[float(_FACE_BYTES[rng.integers(len(_FACE_BYTES))])
                    ] * len(dims),
        n_vcis=int(2 ** rng.integers(0, 3)))


def _sample_serving(rng: np.random.Generator) -> Dict[str, Any]:
    kw = dict(
        arrival=("poisson", "bursty")[rng.integers(2)],
        rate_rps=float(rng.uniform(2000.0, 20000.0)),
        n_requests=int((32, 48, 64)[rng.integers(3)]),
        n_tenants=int((1, 2, 4)[rng.integers(3)]),
        skew=float(rng.uniform(0.0, 0.5)),
        theta=int((4, 8)[rng.integers(2)]),
        part_bytes=float((8192.0, 16384.0)[rng.integers(2)]),
        n_vcis=int((2, 4)[rng.integers(2)]),
        compute_us=float(rng.uniform(0.0, 4.0)),
        seed=int(rng.integers(0, 2 ** 31)))
    if rng.random() < 0.5:
        kw["queue_depth"] = int(rng.integers(3, 9))
        kw["deadline_us"] = float(rng.uniform(200.0, 1000.0))
    return kw


def _check(violations: List[str], cond: bool, msg: str) -> None:
    if not cond:
        violations.append(msg)


def _faulty_equal(a: sim.FaultyResult, b: sim.FaultyResult) -> bool:
    return (a.tts_s == b.tts_s and a.rank_tts_s == b.rank_tts_s
            and a.n_retransmits == b.n_retransmits
            and a.retrans_bytes == b.retrans_bytes
            and a.rounds == b.rounds
            and a.n_hedges == b.n_hedges
            and a.n_suppressed == b.n_suppressed
            and a.duplicate_bytes == b.duplicate_bytes
            and np.array_equal(a.arrival_s, b.arrival_s))


def _serving_equal(a: sim.ServingResult, b: sim.ServingResult) -> bool:
    return (a.tts_s == b.tts_s
            and np.array_equal(a.latency_s, b.latency_s)
            and a.n_retransmits == b.n_retransmits
            and a.retrans_bytes == b.retrans_bytes
            and a.n_shed == b.n_shed and a.completed == b.completed
            and a.n_hedges == b.n_hedges
            and a.n_suppressed == b.n_suppressed
            and a.duplicate_bytes == b.duplicate_bytes)


def _stencil_campaign(idx: int, rng: np.random.Generator,
                      violations: List[str], engine: str,
                      device) -> Dict[str, Any]:
    spec = _sample_spec(rng)
    kw = _sample_stencil(rng)
    policy = POLICIES[rng.integers(len(POLICIES))]
    v = sim.simulate_faulty(faults=spec, policy=policy, engine=engine,
                            device=device, **kw)
    r = sim.simulate_faulty(faults=spec, policy=policy,
                            engine="reference", device=device, **kw)
    _check(violations, _faulty_equal(v, r),
           f"{engine} != reference on faulty stencil")
    _check(violations, v.n_messages == v.n_delivered + v.n_retransmits,
           f"message conservation: {v.n_messages} wire != "
           f"{v.n_delivered} delivered + {v.n_retransmits} retransmits")
    if policy == "hedged":
        _check(violations,
               v.n_hedges == v.n_suppressed + v.n_retransmits,
               f"hedge conservation: {v.n_hedges} hedges != "
               f"{v.n_suppressed} suppressed + {v.n_retransmits}"
               f" retransmits")
    else:
        _check(violations, v.n_hedges == 0 and v.n_suppressed == 0
               and v.duplicate_bytes == 0.0,
               f"policy {policy!r} must not hedge")
    _check(violations, bool(np.all(v.arrival_s >= v.submit_s)),
           "monotone clocks: a message arrived before submission")
    _check(violations, bool(np.all(v.submit_s >= 0.0)),
           "monotone clocks: negative submission time")
    _check(violations, v.rounds <= spec.max_retries + 1,
           f"final-attempt delivery: {v.rounds} rounds > "
           f"max_retries + 1 = {spec.max_retries + 1}")
    _check(violations, v.tts_s >= v.clean_tts_s,
           f"faulty run beat its clean twin: {v.tts_s} < "
           f"{v.clean_tts_s}")
    _check(violations, v.tts_s == max(v.rank_tts_s),
           "tts != max(rank_tts)")
    if idx % RERUN_EVERY == 0:
        again = sim.simulate_faulty(faults=spec, policy=policy,
                                    engine=engine, device=device, **kw)
        _check(violations, _faulty_equal(v, again),
               "determinism: identical campaign re-run diverged")
    return dict(kind="stencil", policy=policy, approach=kw["approach"],
                drop_prob=spec.drop_prob, rounds=v.rounds,
                n_retransmits=v.n_retransmits)


def _serving_campaign(idx: int, rng: np.random.Generator,
                      violations: List[str], engine: str,
                      device) -> Dict[str, Any]:
    spec = _sample_spec(rng)
    kw = _sample_serving(rng)
    policy = POLICIES[rng.integers(len(POLICIES))]
    v = sim.simulate_serving("part", faults=spec, policy=policy,
                             engine=engine, device=device, **kw)
    r = sim.simulate_serving("part", faults=spec, policy=policy,
                             engine="reference", device=device, **kw)
    _check(violations, _serving_equal(v, r),
           f"{engine} != reference on faulty serving")
    _check(violations, v.completed + v.n_shed == v.n_requests,
           f"request conservation: {v.completed} completed + "
           f"{v.n_shed} shed != {v.n_requests} offered")
    if policy == "hedged":
        _check(violations,
               v.n_hedges == v.n_suppressed + v.n_retransmits,
               f"hedge conservation: {v.n_hedges} hedges != "
               f"{v.n_suppressed} suppressed + {v.n_retransmits}"
               f" retransmits")
    else:
        _check(violations, v.n_hedges == 0 and v.n_suppressed == 0
               and v.duplicate_bytes == 0.0,
               f"policy {policy!r} must not hedge")
    _check(violations, bool(np.all(v.latency_s > 0.0)),
           "monotone clocks: a request completed before it arrived")
    _check(violations, 0.0 <= v.goodput_retention <= 1.0,
           f"goodput_retention out of [0, 1]: {v.goodput_retention}")
    if idx % RERUN_EVERY == 0:
        again = sim.simulate_serving("part", faults=spec, policy=policy,
                                     engine=engine, device=device, **kw)
        _check(violations, _serving_equal(v, again),
               "determinism: identical campaign re-run diverged")
    return dict(kind="serving", policy=policy,
                shedding=int("queue_depth" in kw),
                drop_prob=spec.drop_prob, n_shed=v.n_shed,
                n_retransmits=v.n_retransmits)


def run_campaign(idx: int, seed: int = 0, engine: str = "cuda",
                 device="cuda") -> Dict[str, Any]:
    """One seeded campaign: sample, run on ``engine`` and on
    ``reference``, check the invariants.  Returns a summary dict with a
    ``violations`` list (empty = pass); every fourth campaign is a
    serving trace, the rest are stencil exchanges."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, idx]))
    violations: List[str] = []
    if idx % 4 == 3:
        info = _serving_campaign(idx, rng, violations, engine, device)
    else:
        info = _stencil_campaign(idx, rng, violations, engine, device)
    info.update(campaign=idx, violations=violations)
    return info


def run_campaigns(n: int, seed: int = 0,
                  progress: Optional[Any] = None, engine: str = "cuda",
                  device="cuda") -> Dict[str, Any]:
    """Run ``n`` campaigns of ``engine`` against ``reference``; returns
    the report document: per-campaign summaries, aggregate counters,
    and the flattened violation list.  The drivers resolve ``device``:
    asking for the card without one raises in the first campaign."""
    if n < 1:
        raise ValueError(f"need at least 1 campaign, got {n}")
    campaigns = []
    violations = []
    for idx in range(n):
        info = run_campaign(idx, seed=seed, engine=engine, device=device)
        campaigns.append(info)
        violations.extend(
            f"campaign {idx}: {v}" for v in info["violations"])
        if progress is not None:
            progress(idx, info)
    by_policy: Dict[str, int] = {}
    for c in campaigns:
        by_policy[c["policy"]] = by_policy.get(c["policy"], 0) + 1
    return {"n_campaigns": n, "seed": seed, "engine": engine,
            "n_violations": len(violations), "violations": violations,
            "by_policy": by_policy,
            "n_serving": sum(1 for c in campaigns
                             if c["kind"] == "serving"),
            "campaigns": campaigns}
