"""Reading the port's own spans (``repro_torch.telemetry``) in the trace
of a ``--trace 1`` run, and its counters, for the per-layer metrics.

The port opens a named profiler range for each span while the profile
of the traced steps or batches records, so the spans lie in
``run.trace`` among the host operations.  Each device event of the
window (kernel, copy, fill) is given to the innermost ``repro.*`` span
open when the host launched it.  A launch is a host call of the CUDA API
that puts work on a stream (:data:`LAUNCHES`); the trace keeps no link
from a device event to its launch, so the device events, in the order
they start, are paired with the launches in the order they were made.  That pairing holds on one stream; work on a side
stream (the bucket pack, NCCL) may take a neighbour's place, which moves
a kernel between two spans at most at the boundaries around it.  On the
H100 it gave every device event of the three cells the span that the
profiler's correlation ids give it, but 2 of 223 330 (granite prefill).
When the two counts differ the pairing is wrong and nothing is read.
(The trace's device clock may read a start up to a millisecond before
its launch's host start, so the order is the only test.)

A span's device time is the union of its device events' intervals, so
the share of a layer is its kernels' busy time, never the idle time
between them.  A port without ``repro_torch.telemetry`` (an older
checkout) has no such span: each metric is then left out of the result
line.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from .trace import _union

PREFIX = "repro."
LAUNCHES = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx",
                      "cudaMemcpyAsync", "cudaMemsetAsync"))


def _in(name: str, prefix: str) -> bool:
    return name == prefix or name.startswith(prefix + ".")


def attribute(trace) -> Optional[List[Tuple[float, float, Tuple[str, ...]]]]:
    """Each device event of the window with the ``repro.*`` spans open at
    its launch, outermost first: ``(start, end, names)``; None where the
    trace has no such span or the pairing fails (times in us)."""
    host = trace._host
    spans = [(a, b, n) for a, b, n in host if n.startswith(PREFIX)]
    if not spans or not trace.kernels:
        return None
    launches = [a for a, _, n in host if n in LAUNCHES]
    kernels = sorted(trace.kernels)
    if len(launches) != len(kernels):
        return None
    launches.sort()
    spans.sort(key=lambda s: (s[0], -s[1]))
    out, stack, j = [], [], 0
    for t, (a, b, _) in zip(launches, kernels):
        while j < len(spans) and spans[j][0] <= t:   # nested: a stack
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append((a, b, tuple(n for _, _, n in stack)))
    return out


def device_share(run, prefixes: Iterable[str], root: str) -> Optional[float]:
    """The busy time of the device events launched inside spans named
    ``<prefix>`` or ``<prefix>.*`` (forward, ``.recompute`` and ``.bwd``
    alike) as a share of that of the events launched inside ``root``
    spans, in %.  An event counts for the innermost span open at its
    launch, so the work of another layer's span nested inside (remat
    recomputes a layer's attention inside its MoE's backward) is not
    counted.  None without a trace, a root span or device events."""
    if run.trace is None or not run.traced_units:
        return None
    got = attribute(run.trace)
    if got is None:
        return None
    prefixes = list(prefixes)
    part: List[Tuple[float, float]] = []
    whole: List[Tuple[float, float]] = []
    for a, b, chain in got:
        if root not in chain:
            continue
        whole.append((a, b))
        if any(_in(chain[-1], p) for p in prefixes):
            part.append((a, b))
    if not whole:
        return None
    busy = sum(b - a for a, b in _union(whole))
    return 100.0 * sum(b - a for a, b in _union(part)) / busy


def count_share(run, num: str, den: str) -> Optional[float]:
    """The port's counter ``num`` over its counter ``den`` in the traced
    units, in %; None when the run traced none or ``den`` is 0."""
    if not run.traced_units:
        return None
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    counters = telemetry.snapshot()["counters"]
    if not counters.get(den):
        return None
    return 100.0 * counters.get(num, 0) / counters[den]
