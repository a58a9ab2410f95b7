"""Reading a ``torch.profiler`` trace of the measured window.

The window is the host span ``perfbench.window`` (it ends after a
``synchronize``); every device event (kernel, copy, fill; not the host's
named spans, which the profiler mirrors on the device's timeline) is
clipped to it.  Busy time is the union of the device intervals, so kernels of two
streams that overlap count once.  Each idle gap of the window is named
by what the host was doing at its middle: the innermost host operation
or ``perfbench.*`` span open then.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW = "perfbench.window"
TOP = 10
NAME_CHARS = 120


@contextlib.contextmanager
def span(name: str):
    """A named host span in the trace (no cost outside a profile)."""
    with torch.profiler.record_function(name):
        yield


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])


def _annotation(e) -> bool:
    """A span the host named (``record_function``) as the profiler
    mirrors it on the device's timeline: not device work."""
    return bool(getattr(e, "is_user_annotation", False)) \
        or e.name.startswith("perfbench.")


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """The device's work in the window of one profile (times in s)."""

    def __init__(self, prof):
        cuda = torch.autograd.DeviceType.CUDA
        events = prof.events()
        win = [e for e in events if e.name == WINDOW
               and e.device_type != cuda]
        if not win:
            raise RuntimeError("the profile holds no perfbench.window span")
        w0, w1 = win[0].time_range.start, win[0].time_range.end   # us
        self.window_s = (w1 - w0) / 1e6
        self.kernels: List[Tuple[float, float, str]] = []
        host: List[Tuple[float, float, str]] = []
        for e in events:
            a, b = e.time_range.start, e.time_range.end
            if e.device_type == cuda and _annotation(e):
                continue
            if e.device_type == cuda:
                a, b = max(a, w0), min(b, w1)
                if b > a:
                    self.kernels.append((a, b, e.name))
            elif e.name != WINDOW and b > w0 and a < w1:
                host.append((a, b, e.name))
        busy = _union([(a, b) for a, b, _ in self.kernels])
        self.busy_s = sum(b - a for a, b in busy) / 1e6
        gaps, t = [], w0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if w1 > t:
            gaps.append((t, w1))
        self._gaps = gaps
        self._host = sorted(host)

    def device_time_s(self, match: Callable[[str], bool]) -> float:
        """Summed device time of the events whose name matches."""
        return sum(b - a for a, b, n in self.kernels if match(n)) / 1e6

    def launches(self, match: Callable[[str], bool]) -> int:
        return sum(1 for _, _, n in self.kernels if match(n))

    def device_ops(self) -> List[list]:
        """The device events that took most time, summed by name."""
        tot: Dict[str, float] = defaultdict(float)
        for a, b, n in self.kernels:
            tot[n[:NAME_CHARS]] += (b - a) / 1e6
        return [[n, t] for n, t in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:TOP]]

    def _host_at(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self._host, (t, float("inf"), ""))
        best = None
        for a, b, n in reversed(self._host[max(0, i - 2048):i]):
            if a <= t < b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, n)
        return None if best is None else best[2]

    def idle_gaps(self) -> List[list]:
        """Idle time summed by what the host was doing, largest first
        (the 500 longest gaps)."""
        tot: Dict[str, float] = defaultdict(float)
        for a, b in sorted(self._gaps, key=lambda g: g[0] - g[1])[:500]:
            name = self._host_at((a + b) / 2) or "host outside any op"
            tot[name[:NAME_CHARS]] += (b - a) / 1e6
        return [[n, t] for n, t in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:TOP]]
