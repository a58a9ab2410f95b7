"""The launch path shared by the kernels bound through ``ctypes``.

A library entry point takes the raw CUDA stream as its first argument.
:func:`on_stream` passes it the current stream of the tensor's device,
and enters that device only when it is not the current one already: a
``torch.cuda.device`` context and ``torch.cuda.current_stream`` each cost
microseconds a launch, the raw queries a fraction of one.
"""

from __future__ import annotations

import torch

# The current device, and the raw current stream of a device (looked up
# at the first launch: a CPU build of PyTorch has neither).
_QUERIES = None


def on_stream(index: int, fn, *args):
    """``fn(stream, *args)`` with the raw current stream of CUDA device
    ``index``, inside a device context only when ``index`` is not the
    current device; returns what ``fn`` returns."""
    global _QUERIES
    if _QUERIES is None:
        _QUERIES = (torch._C._cuda_getDevice,
                    torch._C._cuda_getCurrentRawStream)
    get_device, get_stream = _QUERIES
    if get_device() == index:
        return fn(get_stream(index), *args)
    with torch.cuda.device(index):
        return fn(get_stream(index), *args)
