"""Fault tolerance: preemption-safe training loop, straggler monitor,
heartbeats.

The port's copy of the JAX package's ``runtime/fault_tolerance.py``
(it holds no JAX code); its retry constants come from the port's
``core/recovery.py``, as the reference's come from its own.

Designed for 1000+ node operation:
  * checkpoint/restart — periodic async saves + signal-triggered final
    save; resume is exact because the data pipeline is stateless in step;
  * straggler mitigation — per-step wall-time tracking flags hosts whose
    step time exceeds k x the rolling median; the hook is where a real
    deployment would trigger hot-spare swap or re-sharding (here: logged
    + counted, and surfaced to the elastic planner);
  * heartbeat file — an external watchdog integration point (the
    coordinator restarts ranks whose heartbeat goes stale).
"""

from __future__ import annotations

import json
import os
import signal
import statistics
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Deque, Dict, List, Optional

from ..core.recovery import (DEFAULT_BACKOFF, DEFAULT_MAX_RETRIES,
                             DEFAULT_TIMEOUT_US)

# Retry knobs, sourced from the shared RecoveryPolicy defaults
# (core/recovery.py) so the runtime and the simulator cannot drift
# apart on two copies of the same numbers.  The runtime's timescale is
# milliseconds where the fabric's is microseconds, hence the 1e-3 on
# the base delay; retries and backoff carry over directly.
RETRY_MAX_ATTEMPTS = DEFAULT_MAX_RETRIES
RETRY_BACKOFF = DEFAULT_BACKOFF
RETRY_BASE_DELAY_S = DEFAULT_TIMEOUT_US * 1e-3
# A heartbeat is considered stale after one missed backoff interval —
# the same factor the fabric applies between retransmission attempts.
HEARTBEAT_STALE_FACTOR = DEFAULT_BACKOFF


def retry_transient(fn: Callable, *, max_attempts: int = RETRY_MAX_ATTEMPTS,
                    backoff: float = RETRY_BACKOFF,
                    base_delay_s: float = RETRY_BASE_DELAY_S,
                    sleep: Callable[[float], None] = time.sleep):
    """Call ``fn()`` with exponential-backoff retries on exception.

    Attempt a (0-based) sleeps ``base_delay_s * backoff ** a`` before
    retrying; the last attempt re-raises.  The defaults are the shared
    recovery constants above — the same truncated-retry
    discipline the fabric's fault injector applies to dropped
    partitions, at runtime timescale.  Used for transient checkpoint
    I/O failures; ``sleep`` is injectable for tests.
    """
    if max_attempts < 1:
        raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
    for a in range(max_attempts):
        try:
            return fn()
        except Exception:
            if a == max_attempts - 1:
                raise
            sleep(base_delay_s * backoff ** a)


@dataclass
class StragglerMonitor:
    """Rolling-median step-time watchdog."""
    window: int = 50
    threshold: float = 2.0
    times: Deque[float] = field(default_factory=deque)
    straggler_steps: List[int] = field(default_factory=list)

    def record(self, step: int, seconds: float) -> bool:
        self.times.append(seconds)
        if len(self.times) > self.window:
            self.times.popleft()
        if len(self.times) >= 10:
            med = statistics.median(self.times)
            if seconds > self.threshold * med:
                self.straggler_steps.append(step)
                return True
        return False

    @property
    def median(self) -> Optional[float]:
        return statistics.median(self.times) if self.times else None


class Heartbeat:
    """Background thread stamping liveness for an external watchdog."""

    def __init__(self, path: str | Path, interval: float = 10.0):
        self.path = Path(path)
        self.interval = interval
        self._step = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def update(self, step: int):
        self._step = step

    def _stamp(self):
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps({"step": self._step,
                                   "time": time.time(),
                                   "pid": os.getpid()}))
        os.replace(tmp, self.path)

    def _run(self):
        while not self._stop.wait(self.interval):
            self._stamp()

    def __enter__(self):
        # Stamp synchronously before the thread's first interval elapses:
        # a watchdog polling a fresh rank must see liveness immediately,
        # not after ``interval`` seconds of looking stale.
        self._stamp()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stale_after(self) -> float:
        """Seconds after which a missing stamp means the rank is dead —
        one missed backoff interval, per the shared recovery factor."""
        return HEARTBEAT_STALE_FACTOR * self.interval

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=self.stale_after())


class PreemptionGuard:
    """Converts SIGTERM/SIGINT into a graceful 'save and exit' request."""

    def __init__(self):
        self.requested = False
        self._orig: Dict[int, object] = {}

    def _handler(self, signum, frame):
        self.requested = True

    def __enter__(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._orig[sig] = signal.signal(sig, self._handler)
            except ValueError:  # non-main thread (tests)
                pass
        return self

    def __exit__(self, *exc):
        for sig, orig in self._orig.items():
            signal.signal(sig, orig)


@dataclass
class LoopReport:
    steps_run: int
    final_step: int
    preempted: bool
    straggler_steps: List[int]
    losses: List[float]


def run_training_loop(*, step_fn: Callable, state, start_step: int,
                      num_steps: int, checkpoint_every: int,
                      checkpointer, get_batch: Callable,
                      on_loss: Optional[Callable] = None,
                      straggler: Optional[StragglerMonitor] = None,
                      heartbeat: Optional[Heartbeat] = None) -> LoopReport:
    """The fault-tolerant inner loop.

    ``step_fn(state, batch) -> (state, loss)``; ``state`` is the full
    checkpointable pytree (params + opt state).  Exceptions and
    preemptions trigger a final synchronous save of the last *completed*
    step — never a step id that did not finish (a mid-step exception
    leaves ``state`` at the previous step, and ``num_steps == 0`` has
    nothing to save at all), and never a duplicate of a periodic save
    that already covered it.
    """
    straggler = straggler or StragglerMonitor()
    losses: List[float] = []
    preempted = False
    # ``completed`` is the step id the current ``state`` belongs to:
    # advanced the moment step_fn returns the new state, so the final
    # save can never stamp stale state with a completed-step id.
    completed = start_step
    last_saved: Optional[int] = None
    with PreemptionGuard() as guard:
        try:
            for step in range(start_step, start_step + num_steps):
                t0 = time.perf_counter()
                state, loss = step_fn(state, get_batch(step))
                completed = step + 1
                loss = float(loss)
                losses.append(loss)
                dt = time.perf_counter() - t0
                if straggler.record(step, dt):
                    print(f"[straggler] step {step}: {dt:.3f}s "
                          f"(median {straggler.median:.3f}s)")
                if heartbeat is not None:
                    heartbeat.update(step)
                if on_loss is not None:
                    on_loss(step, loss)
                if checkpoint_every and (step + 1) % checkpoint_every == 0:
                    checkpointer.save_async(step + 1, state)
                    last_saved = step + 1
                if guard.requested:
                    preempted = True
                    break
        finally:
            checkpointer.wait()
            if completed > start_step and last_saved != completed:
                # the final save is the one that must not be lost to a
                # transient I/O hiccup: retry it on the shared backoff
                def _final_save():
                    checkpointer.save_async(completed, state)
                    checkpointer.wait()
                retry_transient(_final_save)
    return LoopReport(steps_run=len(losses), final_step=completed,
                      preempted=preempted,
                      straggler_steps=list(straggler.straggler_steps),
                      losses=losses)
