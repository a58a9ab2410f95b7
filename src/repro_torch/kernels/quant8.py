"""Blockwise int8 quantize / dequantize: the wrapper of the hand-written
CUDA kernels in ``csrc/quant8.cu`` and their plain PyTorch versions.

Counterpart of the JAX package's ``kernels/quant8.py``, whose Pallas
kernels (``_quant_kernel`` and ``_dequant_kernel``) these replace:
symmetric int8 quantization of a flat vector over blocks of ``BLOCK``
elements, one f32 scale per block.  A ragged tail is quantized as if
padded with zeros (the Pallas kernel pads to whole tiles and trims), so
``n`` values and ``ceil(n / BLOCK)`` scales come back.  The scale is a
true division by 127 as in the eager reference; the jitted Pallas kernel
multiplies by ``1/127`` instead and differs from it by one ulp in some
scales.  Non-finite inputs go as in JAX: a NaN in a block makes its
scale NaN, an infinity makes it infinite, and a NaN quotient quantizes
to 0.

:func:`quantize_blockwise` and :func:`dequantize_blockwise` launch the
kernels for CUDA tensors only; the public entry points that take the
plain versions for CPU tensors are in ``kernels.ops``.  f32 and bf16 go
to the quantize kernel as they are; other float dtypes are cast to f32
first.  Each launch takes one of two routes, picked on the host by
:func:`route` from its input: ``vec`` (16-byte accesses) for bf16 or
int8 data 16-byte aligned, ``scalar`` for f32 (whose 4-byte loads
already fill whole sectors) and for a view at an odd element offset.
The library picks each launch's grid.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import launch, ref

BLOCK = 256  # elements per quantization block

# Launch counts: one per launch the wrappers make, and nowhere else.
LAUNCHES = {"quantize_blockwise": 0, "dequantize_blockwise": 0}
# The route each launch took (both kernels).
ROUTES = {"vec": 0, "scalar": 0}

_LIB = {}
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The dtypes the quantize kernel reads as they are, by their code there.
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The library's entry points, each (stream, input, vec, ...) -> a CUDA
# error code: quantize (..., dtype, n, q, scales), dequantize (...,
# scales, n, y).
SIGNATURES = {"quantize_blockwise": [_VP, _VP, _I, _I, _LL, _VP, _VP],
              "dequantize_blockwise": [_VP, _VP, _I, _VP, _LL, _VP]}


def _library() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/quant8.cu``."""
    lib = _LIB.get("quant8")
    if lib is None:
        from . import build
        lib = build.load("quant8")
        for name, argtypes in SIGNATURES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = _I
        lib.quant8_error_string.argtypes = [_I]
        lib.quant8_error_string.restype = ctypes.c_char_p
        _LIB["quant8"] = lib
    return lib


def route(t: torch.Tensor) -> str:
    """The route of a launch whose input is ``t``: ``vec`` when it is not
    f32 and its data is 16-byte aligned (every block or tile then is
    too), else ``scalar``.  f32 quantize always takes ``scalar``: its
    4-byte loads fill whole sectors, and 16-byte ones measured slower.
    The outputs are the wrapper's own allocations and always aligned;
    the scales are read one at a time."""
    if t.dtype == torch.float32:
        return "scalar"
    return "vec" if t.data_ptr() % 16 == 0 else "scalar"


def n_blocks(n: int) -> int:
    return -(-n // BLOCK)


def _check_x(x: torch.Tensor) -> None:
    if x.dim() != 1 or x.numel() < 1:
        raise ValueError(f"quantize_blockwise: need a non-empty flat vector,"
                         f" got {tuple(x.shape)}")
    if not x.dtype.is_floating_point:
        raise TypeError(f"quantize_blockwise: dtype {x.dtype} is not a"
                        f" float")


def _check_q(q: torch.Tensor, scales: torch.Tensor) -> None:
    if q.dim() != 1 or q.numel() < 1 or q.dtype != torch.int8:
        raise ValueError(f"dequantize_blockwise: need a non-empty int8"
                         f" vector, got {q.dtype} {tuple(q.shape)}")
    if scales.shape != (n_blocks(q.numel()),) \
            or scales.dtype != torch.float32 or scales.device != q.device:
        raise ValueError(f"dequantize_blockwise: need {n_blocks(q.numel())}"
                         f" f32 scales on {q.device}, got {scales.dtype}"
                         f" {tuple(scales.shape)} on {scales.device}")


def quantize_blockwise_plain(x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The quantize kernel's plain version: :func:`ref
    .quantize_blockwise_ref` on ``x`` zero-padded to whole blocks, the
    padding trimmed off the values."""
    _check_x(x)
    n = x.numel()
    q, s = ref.quantize_blockwise_ref(F.pad(x.float(), (0, (-n) % BLOCK)),
                                      BLOCK)
    return q[:n], s


def dequantize_blockwise_plain(q: torch.Tensor, scales: torch.Tensor
                               ) -> torch.Tensor:
    """The dequantize kernel's plain version: :func:`ref
    .dequantize_blockwise_ref` on zero-padded values, trimmed."""
    _check_q(q, scales)
    n = q.numel()
    return ref.dequantize_blockwise_ref(F.pad(q, (0, (-n) % BLOCK)), scales,
                                        BLOCK)[:n]


def _on_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} kernel: tensors on {t.device}, not on a"
                         f" CUDA device")


def _raise_if(rc: int, lib, what: str) -> None:
    if rc != 0:
        msg = lib.quant8_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _launch(fn, t: torch.Tensor, what: str, *args) -> None:
    """One launch of ``fn`` over the elements of ``t`` on the current
    stream of its device, on the route :func:`route` picks for ``t``."""
    r = route(t)
    rc = launch.on_stream(t.get_device(), fn, t.data_ptr(), r == "vec",
                          *args)
    LAUNCHES[what] += 1
    ROUTES[r] += 1
    _raise_if(rc, _LIB["quant8"], what)


def quantize_blockwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the quantize kernel on a flat CUDA vector (f32 and bf16 read
    as they are, other floats cast to f32 as the reference does): (int8
    values of ``len(x)``, f32 scales of ``ceil(len(x) / BLOCK)``).  Raises
    for a tensor not on a CUDA device and for a failed launch."""
    _check_x(x)
    _on_cuda(x, "quantize_blockwise")
    code = _DTYPE_CODE.get(x.dtype)
    if code is None:
        x, code = x.float(), 0
    x = x.contiguous()
    n = x.numel()
    q = torch.empty(n, dtype=torch.int8, device=x.device)
    s = torch.empty(n_blocks(n), dtype=torch.float32, device=x.device)
    lib = _library()
    _launch(lib.quantize_blockwise, x, "quantize_blockwise", code, n,
            q.data_ptr(), s.data_ptr())
    return q, s


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor
                         ) -> torch.Tensor:
    """Launch the dequantize kernel: int8 values and their f32 block
    scales on a CUDA device -> f32 of ``len(q)``.  Raises for tensors
    not on a CUDA device and for a failed launch."""
    _check_q(q, scales)
    _on_cuda(q, "dequantize_blockwise")
    q, scales = q.contiguous(), scales.contiguous()
    n = q.numel()
    y = torch.empty(n, dtype=torch.float32, device=q.device)
    lib = _library()
    _launch(lib.dequantize_blockwise, q, "dequantize_blockwise",
            scales.data_ptr(), n, y.data_ptr())
    return y
