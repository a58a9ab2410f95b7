"""The launch path the ctypes-bound kernels share
(``kernels.launch.on_stream``): the raw current stream of the tensor's
device, and a device context only when that device is not the current
one.  The CUDA queries and ``torch.cuda.device`` are replaced by fakes
that track the current device, so this runs on the CPU."""

import contextlib

import pytest
import torch

from repro_torch.kernels import launch


@pytest.mark.parametrize("current", [0, 1])
@pytest.mark.parametrize("index", [0, 1, 2])
def test_on_stream_enters_a_device_only_when_not_current(monkeypatch,
                                                         current, index):
    state = {"device": current}
    entered = []

    @contextlib.contextmanager
    def device(i):
        entered.append(i)
        before, state["device"] = state["device"], i
        try:
            yield
        finally:
            state["device"] = before

    monkeypatch.setattr(launch, "_QUERIES",
                        (lambda: state["device"], lambda i: 100 + i))
    monkeypatch.setattr(torch.cuda, "device", device)
    seen = []

    def fn(stream, *args):
        seen.append((stream, state["device"], args))
        return 7
    assert launch.on_stream(index, fn, "a", 3) == 7
    assert seen == [(100 + index, index, ("a", 3))]
    assert entered == ([] if index == current else [index])
    assert state["device"] == current
