"""Analytic performance model of pipelined (partitioned) communication.

Implements the closed-form model of Gillis et al., ICPP'23, §2.2 + Appendix A:

  eq (1)  eta = T_b / T_p
  eq (2)  T_b ≈ N_part * S_part / beta
  eq (3)  T_p ≈ max{(N_part - 1) * S_part / beta - D, 0} + S_part / beta
  eq (4)  eta_large = N*theta / max{N*theta - gamma_theta * beta, 1}
  eq (5)  eta_small = 1 / (N * theta)
  eq (6)  mu = (AI / CI) / (8 F)
  eq (8)  D = gamma_theta * S_part
  eq (9)  gamma_theta = mu * (theta + (eps + delta)/2 * (sqrt(theta) + 1) - 1)

The port's copy of the JAX package's ``core/perfmodel.py``, without
the reference's TPU hardware constants (planner inputs, not this
package's numbers).

Unit conventions (chosen so the paper's own numeric examples reproduce
exactly):

  * ``gamma`` and ``mu`` are expressed in **µs/MB** (the paper's unit).
  * ``beta`` is in **bytes/second**.
  * The dimensionless product used by eq (4) is ``gamma * beta`` after
    converting gamma to s/B: ``gamma_us_per_mb * 1e-12 * beta``.

Paper constants reproduced (validated in tests):
  * FFT example (App. A.2.1):   F=3.5 GHz, beta=25 GB/s, AI=5, CI=1,
    eps=0.04, delta=0  -> gamma_1=7.1428, gamma_2=187.1936, gamma_8=1263.67
    and eta = 1.0228 / 1.4134 / 1.9748 at N=8.
  * Stencil example (App. A.2.2): AI=1/13, CI=(66/64)^3-1, delta=0.5,
    eps=0.04 -> gamma_1=15.3398, gamma_2=46.9239, gamma_8=228.2131.  The
    paper's quoted eta values (1.1060/1.1718/1.2169) are only consistent
    with beta=50 GB/s (not the 25 GB/s used for FFT); we expose beta as an
    argument and document the discrepancy.
  * §2.2.1 examples: theta=1, beta=25 GB/s, N=8, gamma in {1,10} µs/MB
    -> eta = 1.003 / 1.032; theta=8, gamma=1000 -> eta = 1.641.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

US_PER_MB_TO_S_PER_B = 1e-12  # 1 µs/MB = 1e-6 s / 1e6 B


# ---------------------------------------------------------------------------
# §2.2 — gain model
# ---------------------------------------------------------------------------

def bulk_time(n_part: int, s_part: float, beta: float) -> float:
    """eq (2): communication time of bulk thread-sync, in seconds.

    ``s_part`` in bytes, ``beta`` in B/s.
    """
    return n_part * s_part / beta


def pipelined_time(n_part: int, s_part: float, beta: float, delay: float) -> float:
    """eq (3): communication time of the pipelined pattern, in seconds.

    ``delay`` (seconds) is the time between the first and last partition
    becoming ready; at most the first ``n_part - 1`` transmissions overlap it.
    """
    return max((n_part - 1) * s_part / beta - delay, 0.0) + s_part / beta


def eta_large(n_threads: int, theta: float, gamma_us_per_mb: float,
              beta: float) -> float:
    """eq (4): predicted gain for large (bandwidth-bound) messages.

    ``gamma_us_per_mb`` is the delay rate in µs/MB, ``beta`` in B/s.
    """
    n_part = n_threads * theta
    gb = gamma_us_per_mb * US_PER_MB_TO_S_PER_B * beta
    return n_part / max(n_part - gb, 1.0)


def eta_small(n_threads: int, theta: float) -> float:
    """eq (5): predicted gain for small (latency-bound) messages (< 1)."""
    return 1.0 / (n_threads * theta)


# ---------------------------------------------------------------------------
# Appendix A — delay-rate model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Workload:
    """An application kernel characterized as in Appendix A.

    Attributes:
      ai: arithmetic intensity, flop/B.
      ci: communication intensity — bytes sent/received per byte of memory
          touched by the algorithm.
      eps: system-execution noise (fraction).
      delta: algorithmic imbalance (fraction).
      freq_hz: CPU frequency F; the paper's examples use 3.5 GHz.
    """
    ai: float
    ci: float
    eps: float = 0.0
    delta: float = 0.0
    freq_hz: float = 3.5e9

    @property
    def mu_s_per_b(self) -> float:
        """eq (6): average computation rate, seconds per byte."""
        return (self.ai / self.ci) / (8.0 * self.freq_hz)

    @property
    def mu_us_per_mb(self) -> float:
        return self.mu_s_per_b / US_PER_MB_TO_S_PER_B

    @property
    def sigma(self) -> float:
        """Noise std-dev factor: sigma = (eps + delta) / 2."""
        return (self.eps + self.delta) / 2.0

    def gamma(self, theta: float) -> float:
        """eq (9): delay rate gamma_theta in µs/MB."""
        return self.mu_us_per_mb * (
            theta + self.sigma * (math.sqrt(theta) + 1.0) - 1.0)

    def delay_seconds(self, theta: float, s_part: float) -> float:
        """eq (8): delay D = gamma_theta * S_part, in seconds."""
        return self.gamma(theta) * US_PER_MB_TO_S_PER_B * s_part

    def eta(self, n_threads: int, theta: float, beta: float) -> float:
        """eq (4) evaluated with this workload's delay rate."""
        return eta_large(n_threads, theta, self.gamma(theta), beta)

    def sample_partition_seconds(self, n_threads: int, theta: int,
                                 s_part: float,
                                 rng: np.random.Generator) -> np.ndarray:
        """Appendix-A noise model: per-partition compute time drawn as
        ``mu * S_part * N(1, sigma)`` with ``sigma = (eps + delta) / 2``,
        clipped at zero.  Shape ``(n_threads, theta)``."""
        per = self.mu_s_per_b * s_part * rng.normal(
            1.0, max(self.sigma, 0.0), size=(n_threads, theta))
        return np.maximum(per, 0.0)

    def sample_ready(self, n_threads: int, theta: int, s_part: float,
                     rng: np.random.Generator) -> np.ndarray:
        """Per-partition ready times: noise-model compute accumulated
        sequentially on each thread (the simulator's ``ready`` array).
        The expected spread between first and last ready time is eq (8)'s
        ``D = gamma_theta * S_part``."""
        return self.sample_partition_seconds(
            n_threads, theta, s_part, rng).cumsum(axis=1)


# The paper's two worked examples (App. A.2).
FFT = Workload(ai=5.0, ci=1.0, eps=0.04, delta=0.0)
STENCIL = Workload(ai=1.0 / 13.0, ci=(66.0 / 64.0) ** 3 - 1.0,
                   eps=0.04, delta=0.5)

# Named registry (sweep specs and CLIs reference workloads by name).
WORKLOADS = {"fft": FFT, "stencil": STENCIL}

# Network constants.
MELUXINA_BETA = 25e9          # 200 Gb/s HDR IB, as used in the paper's figures
MELUXINA_LATENCY = 1.22e-6    # paper footnote 1
STENCIL_EXAMPLE_BETA = 50e9   # the beta implied by the paper's stencil etas


# ---------------------------------------------------------------------------
# Break-even analysis (paper §4.3: ~100 kB crossover)
# ---------------------------------------------------------------------------

def breakeven_partition_bytes(n_threads: int, theta: float,
                              gamma_us_per_mb: float, beta: float,
                              alpha_s: float, contention_factor: float = 1.0,
                              hi: float = 1 << 30) -> float:
    """Smallest partition size at which pipelining wins over bulk.

    Bulk sends one aggregate message (one latency ``alpha_s``); pipelined
    sends ``N*theta`` messages each paying a (possibly contended) latency but
    overlapping the delay ``gamma * S``.  Bisect on S.
    """
    n_part = n_threads * theta
    gamma_sb = gamma_us_per_mb * US_PER_MB_TO_S_PER_B

    def gain(s: float) -> float:
        tb = alpha_s + n_part * s / beta
        tp = (alpha_s * contention_factor * n_part
              + pipelined_time(n_part, s, beta, gamma_sb * s))
        return tb / tp

    lo = 1.0
    if gain(hi) <= 1.0:
        return math.inf
    if gain(lo) > 1.0:
        return lo
    for _ in range(200):
        mid = math.sqrt(lo * hi)  # geometric bisection over sizes
        if gain(mid) > 1.0:
            hi = mid
        else:
            lo = mid
    return hi
