"""Open-loop request arrival traces for the serving scenario.

The port's copy of the JAX package's ``core/arrivals.py``: a trace is
bitwise the same for the same parameters and seed in both packages.

Every other scenario is closed-loop: a fixed grid of flows starts at
t=0 and the metric is completion time.  Serving workloads are
*open-loop* — requests arrive on their own clock whether or not the
fabric has drained the previous ones, so late partitions compound into
queueing delay and the interesting metrics are the latency *tail*
(p99/p999) and goodput versus offered load.

This module generates the arrival side: deterministic, seeded request
traces with no wall-clock dependence, so a trace is a pure function of
its parameters and CI / resumed runs always replay the identical
workload.  Three generators cover the standard serving regimes:

  * :func:`poisson_trace` — memoryless arrivals (exponential gaps), the
    M/G/1-style baseline.
  * :func:`bursty_trace` — arrivals clump into bursts (geometric burst
    sizes, Poisson burst epochs, near-back-to-back gaps inside a
    burst).  Same mean rate as the Poisson trace, far heavier tail
    pressure: a burst lands on the fabric faster than it drains.
  * :func:`multi_tenant_trace` — N tenants with (optionally Zipf-skewed)
    per-tenant rates, each an independent substream, merged in time
    order.  Tenant ids drive VCI/thread sharing in the serving driver.

``ARRIVALS`` registers the single-tenant generators by name so sweep
specs can select a model with a plain string; :func:`make_trace` is the
one entry point the drivers use.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Trace:
    """An open-loop request trace: when each request arrives, and whose
    it is.  ``t`` is float64 seconds from the trace epoch, sorted
    non-decreasing; ``tenant`` is the owning tenant id per request."""

    t: np.ndarray       # float64, sorted arrival times (seconds)
    tenant: np.ndarray  # int64, tenant id per request

    def __post_init__(self):
        if self.t.shape != self.tenant.shape:
            raise ValueError("t and tenant must have matching shapes")
        if self.t.size and np.any(np.diff(self.t) < 0.0):
            raise ValueError("arrival times must be sorted non-decreasing")

    def __len__(self) -> int:
        return int(self.t.shape[0])

    @property
    def n_tenants(self) -> int:
        return int(self.tenant.max()) + 1 if len(self) else 0

    @property
    def span_s(self) -> float:
        """First-to-last arrival span (the offered-load denominator)."""
        return float(self.t[-1] - self.t[0]) if len(self) > 1 else 0.0

    @property
    def offered_rps(self) -> float:
        """Empirical offered load: requests per second over the span."""
        return (len(self) - 1) / self.span_s if self.span_s > 0.0 else 0.0


def _merge(traces) -> Trace:
    """Merge traces in time order (stable: ties keep input order)."""
    t = np.concatenate([tr.t for tr in traces])
    tenant = np.concatenate([tr.tenant for tr in traces])
    order = np.argsort(t, kind="stable")
    return Trace(t=t[order], tenant=tenant[order])


def poisson_trace(rate_rps: float, n_requests: int, *, seed: int = 0,
                  tenant: int = 0, t0: float = 0.0) -> Trace:
    """Memoryless open-loop arrivals: exponential inter-arrival gaps with
    mean ``1 / rate_rps``, first request at ``t0``."""
    if rate_rps <= 0.0:
        raise ValueError("rate_rps must be positive")
    if n_requests <= 0:
        raise ValueError("n_requests must be positive")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n_requests - 1)
    t = t0 + np.concatenate([[0.0], np.cumsum(gaps)])
    return Trace(t=t, tenant=np.full(n_requests, tenant, dtype=np.int64))


def bursty_trace(rate_rps: float, n_requests: int, *, burst_mean: float = 4.0,
                 intra_gap_frac: float = 0.05, seed: int = 0,
                 tenant: int = 0, t0: float = 0.0) -> Trace:
    """Bursty arrivals at the same mean rate as :func:`poisson_trace`.

    Burst epochs are Poisson at ``rate_rps / burst_mean``; each burst
    carries a geometric number of requests (mean ``burst_mean``) spaced
    ``intra_gap_frac / rate_rps`` apart — a clump arrives much faster
    than the fabric's steady drain rate, so the same offered load
    produces a far heavier latency tail than the memoryless trace.
    """
    if rate_rps <= 0.0:
        raise ValueError("rate_rps must be positive")
    if n_requests <= 0:
        raise ValueError("n_requests must be positive")
    if burst_mean < 1.0:
        raise ValueError("burst_mean must be >= 1")
    rng = np.random.default_rng(seed)
    intra = intra_gap_frac / rate_rps
    burst_rate = rate_rps / burst_mean
    times = []
    epoch = t0
    while len(times) < n_requests:
        size = int(rng.geometric(1.0 / burst_mean))
        for k in range(size):
            times.append(epoch + k * intra)
        epoch += rng.exponential(1.0 / burst_rate)
    # A long burst's tail can straddle the next epoch; the physical trace
    # is the merged point process, so sort before keeping the first n.
    t = np.sort(np.array(times, dtype=np.float64))[:n_requests]
    return Trace(t=t, tenant=np.full(n_requests, tenant, dtype=np.int64))


ARRIVALS = {
    "poisson": poisson_trace,
    "bursty": bursty_trace,
}


def _tenant_weights(n_tenants: int, skew: float) -> np.ndarray:
    """Per-tenant rate shares: uniform at ``skew=0``, Zipf-like
    ``(i + 1) ** -skew`` otherwise, normalized to sum to 1."""
    w = (np.arange(n_tenants, dtype=np.float64) + 1.0) ** -float(skew)
    return w / w.sum()


def multi_tenant_trace(model: str, rate_rps: float, n_requests: int, *,
                       n_tenants: int, skew: float = 0.0, seed: int = 0,
                       t0: float = 0.0) -> Trace:
    """N tenants sharing the fabric: per-tenant independent substreams
    of the chosen ``model`` merged in time order.

    Aggregate rate is ``rate_rps``; tenant i's share is uniform or
    Zipf-skewed (``(i+1)^-skew``), and its request count is the largest
    -remainder apportionment of ``n_requests`` (so counts are exact and
    deterministic).  Substream seeds derive from ``seed`` via
    ``SeedSequence.spawn`` — tenants are independent, yet the whole
    trace is still a pure function of ``(model, rate, n, tenants, skew,
    seed)``.
    """
    if n_tenants <= 0:
        raise ValueError("n_tenants must be positive")
    if n_requests < n_tenants:
        raise ValueError("need at least one request per tenant")
    gen = ARRIVALS.get(model)
    if gen is None:
        raise ValueError(
            f"unknown arrival model {model!r}; one of {tuple(ARRIVALS)}")
    w = _tenant_weights(n_tenants, skew)
    # largest-remainder apportionment, at least one request per tenant
    counts = np.maximum(1, np.floor(w * n_requests).astype(np.int64))
    while counts.sum() > n_requests:
        counts[int(np.argmax(counts))] -= 1
    while counts.sum() < n_requests:
        counts[int(np.argmin(counts / w))] += 1
    seeds = [int(s.generate_state(1)[0])
             for s in np.random.SeedSequence(seed).spawn(n_tenants)]
    parts = [gen(rate_rps * w[i], int(counts[i]), seed=seeds[i],
                 tenant=i, t0=t0)
             for i in range(n_tenants)]
    return _merge(parts)


def make_trace(model: str, rate_rps: float, n_requests: int, *,
               n_tenants: int = 1, skew: float = 0.0,
               seed: int = 0, t0: float = 0.0) -> Trace:
    """The drivers' entry point: one tenant dispatches straight to the
    named generator, several go through :func:`multi_tenant_trace`."""
    if n_tenants <= 1:
        gen = ARRIVALS.get(model)
        if gen is None:
            raise ValueError(
                f"unknown arrival model {model!r}; one of {tuple(ARRIVALS)}")
        return gen(rate_rps, n_requests, seed=seed, t0=t0)
    return multi_tenant_trace(model, rate_rps, n_requests,
                              n_tenants=n_tenants, skew=skew, seed=seed,
                              t0=t0)
