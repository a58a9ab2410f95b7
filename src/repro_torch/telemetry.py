"""Spans and device counters inside the port, recorded only while a
``torch.profiler`` profile records.

Every entry point first asks ``torch._C._autograd._profiler_enabled()``.
While no profile is active that is all it does: :func:`span` returns one
preallocated no-op context, :func:`mark_in` and :func:`mark_out` return
their argument itself, :func:`count` returns; no profiler range, no
record, no kernel launch and no autograd node.  There is no environment
variable and no flag: a profile is the switch.

While a profile records:

- ``span(name)`` opens a profiler range named ``name`` (the fast
  ``RecordFunction`` of ``torch._C._profiler``, about 2 us where
  ``record_function`` takes about 17), so the span lies in the
  profiler's trace among the host operations, on the clock of the device
  events; a reader of the trace gives it the kernels launched inside it.
  The span's name, its parent (the enclosing span, on one stack for the
  process: backward runs on the autograd engine's thread while the
  caller waits inside ``repro.backward``) and its host start and end
  (``perf_counter_ns``) are kept in flat arrays, so the records add no
  object for the garbage collector to trace.  A span opened inside
  backward with grad mode on -- remat's recomputation
  (``torch.utils.checkpoint`` recomputes under ``enable_grad``) -- is
  recorded as ``<name>.recompute``.
- ``mark_in(x, name)`` and ``mark_out(y, name)``, at a region's
  input(s) and output, give the region a span in backward through hooks
  on autograd nodes: the node that made the output opens ``<name>.bwd``
  before it runs, and a view of each input closes the span once the last
  has its gradient.  Under ``no_grad``, for a tensor that needs no
  gradient, or in a recomputation, they return the tensor itself; a mark
  left unmatched is dropped, never raised.
- ``count(name, value)`` adds a host int, or a device scalar without a
  sync, into the counter ``name``; a count made inside backward (a
  recomputation) is skipped, the forward having made it.

On a switch from off to on the records and counters are cleared, so
:func:`snapshot` holds the latest profile only (a switch is seen by the
first call of the port, or by :func:`snapshot`, after a profile ends).
Records stay in memory and are written nowhere: the profiler's own
chrome trace is the timeline.  The span names and the metric each is
for are listed in ``PERF.md``.
"""

from __future__ import annotations

import time
from array import array
from typing import Dict, List

import torch

_enabled = torch._C._autograd._profiler_enabled
_graph_task = torch._C._current_graph_task_id
_Range = torch._C._profiler._RecordFunctionFast


class _Null:
    """The context :func:`span` returns while no profile records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _Null()


class _Recorder:
    """The records of the latest profile: span ``i`` is ``names[i]``,
    opened at ``t0[i]`` and closed at ``t1[i]`` (0 while open) inside
    span ``parents[i]`` (-1: a root); the open spans on a stack beside
    their profiler ranges; the counters; and the forward regions
    awaiting their ``mark_out``."""

    def __init__(self):
        self.on = False
        self.clear()

    def clear(self) -> None:
        self.names: List[str] = []
        self.parents = array("q")
        self.t0 = array("q")
        self.t1 = array("q")
        self.stack: List[int] = []
        self.ranges: list = []
        self.host_counts: Dict[str, int] = {}
        self.dev_counts: Dict[str, torch.Tensor] = {}
        self.regions: Dict[str, "_Region"] = {}

    def open(self, name: str) -> int:
        i = len(self.names)
        self.names.append(name)
        self.parents.append(self.stack[-1] if self.stack else -1)
        self.t1.append(0)
        r = _Range(name)
        r.__enter__()
        self.stack.append(i)
        self.ranges.append(r)
        self.t0.append(time.perf_counter_ns())
        return i

    def close(self, i: int) -> None:
        """Close span ``i``; spans opened after it and still open are
        unmatched, and are ended in the trace and dropped here."""
        if i not in self.stack:
            return
        self.t1[i] = time.perf_counter_ns()
        j = self.stack.index(i)
        for r in reversed(self.ranges[j:]):
            r.__exit__(None, None, None)
        del self.stack[j:], self.ranges[j:]


_R = _Recorder()


def _active() -> bool:
    """Whether a profile records; the first call of a profile clears
    the previous one's records."""
    if not _enabled():
        _R.on = False
        return False
    if not _R.on:
        _R.clear()
        _R.on = True
    return True


def counting() -> bool:
    """Whether :func:`count` keeps a count now: a profile records and
    this is not backward (remat's recomputation counts nothing again)."""
    return _active() and _graph_task() == -1


class _Open:
    """The context of a span while a profile records."""

    __slots__ = ("name", "i")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _R.regions.pop(self.name, None)
        name = self.name
        if _graph_task() != -1 and torch.is_grad_enabled():
            name += ".recompute"
        self.i = _R.open(name)
        return None

    def __exit__(self, *exc) -> bool:
        _R.close(self.i)
        return False


def span(name: str):
    """A context: the span ``name`` while a profile records, else
    nothing."""
    if not _active():
        return _NULL
    return _Open(name)


class _Region:
    """A marked region: its name, its marked inputs whose gradient has
    not been computed yet, and its open ``.bwd`` span; its methods are
    the hooks of the autograd nodes at its output and inputs."""

    __slots__ = ("name", "pending", "i")

    def __init__(self, name: str):
        self.name, self.pending, self.i = name, 0, None

    def opened(self, grad_outputs):
        if self.i is None and self.pending > 0 and _active():
            self.i = _R.open(self.name + ".bwd")

    def closed(self, grad_inputs, grad_outputs):
        self.pending -= 1
        if self.pending == 0 and self.i is not None:
            _R.close(self.i)
            self.i = None


def _marks(x: torch.Tensor) -> bool:
    """Whether to mark ``x``: a profile records, ``x`` takes part in a
    graph, and this is no recomputation (whose graph is never run
    backward)."""
    return torch.is_grad_enabled() and x.requires_grad and _active() \
        and _graph_task() == -1


def mark_in(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` as an input of the region ``name``: a view of it, whose
    autograd node's hook closes the region's backward span once every
    marked input has its gradient."""
    if not _marks(x):
        return x
    r = _R.regions.get(name)
    if r is None:
        r = _R.regions[name] = _Region(name)
    r.pending += 1
    v = x.view_as(x)
    v.grad_fn.register_hook(r.closed)
    return v


def mark_out(y: torch.Tensor, name: str) -> torch.Tensor:
    """``y`` as the output of the region ``name``: a hook on the node
    that made it opens the span ``<name>.bwd`` before that node runs
    backward."""
    if not _marks(y) or y.grad_fn is None:
        return y
    r = _R.regions.pop(name, None)
    if r is not None and r.pending > 0:
        y.grad_fn.register_prehook(r.opened)
    return y


def count(name: str, value) -> None:
    """Add ``value`` (a host int, or a device scalar, added on the
    device) to the counter ``name`` while :func:`counting`."""
    if not counting():
        return
    if isinstance(value, torch.Tensor):
        acc = _R.dev_counts.get(name)
        if acc is None:
            acc = _R.dev_counts[name] = torch.zeros(
                (), dtype=torch.int64, device=value.device)
        acc.add_(value)
    else:
        _R.host_counts[name] = _R.host_counts.get(name, 0) + int(value)


def snapshot() -> dict:
    """The latest profile's records: ``{"spans": {name: {"calls",
    "host_s", "host_self_s"}}, "counters": {name: int}}``.  A span's
    self time is its time less its child spans' (which nest inside it,
    on one stack).  Device counters are read here, one sync each.  Spans
    never closed are left out."""
    if not _enabled():    # read after its profile: the next one clears
        _R.on = False
    spans: Dict[str, dict] = {}
    names, parents, t0, t1 = _R.names, _R.parents, _R.t0, _R.t1
    for i, name in enumerate(names):
        if not t1[i]:
            continue
        d = (t1[i] - t0[i]) * 1e-9
        row = spans.setdefault(name, {"calls": 0, "host_s": 0.0,
                                      "host_self_s": 0.0})
        row["calls"] += 1
        row["host_s"] += d
        row["host_self_s"] += d
        p = parents[i]
        if p >= 0 and t1[p]:
            spans[names[p]]["host_self_s"] -= d
    counters = dict(_R.host_counts)
    for k, acc in _R.dev_counts.items():
        counters[k] = counters.get(k, 0) + int(acc.item())
    return {"spans": spans, "counters": counters}


def reset() -> None:
    """Forget every record and counter (a profile clears them too)."""
    _R.on = False
    _R.clear()
