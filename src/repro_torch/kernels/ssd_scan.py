"""Mamba-2's chunked SSD scan: the wrapper of the hand-written CUDA
kernels in ``csrc/ssd_scan.cu`` and their plain PyTorch version.

The kernels replace no Pallas kernel: the JAX package leaves the SSD to
XLA.  They compute exactly ``models.mamba.ssd_chunked`` (forward only)
for the paths on which autograd records nothing (the served prefill),
in f32 arithmetic, reading x, B and C in the dtype they arrive in and
writing y in x's dtype and the final state in f32.  A call is a fixed
chain of three launches whatever the length (:data:`KERNELS`): the chunk
states, the pass over the chunks that turns them into the states
entering each chunk, and the outputs.  See the source for the design.

:func:`ssd_scan` launches the kernels for CUDA tensors only; the public
entry point, which takes the plain version (:func:`ssd_scan_plain`, that
is ``ssd_chunked``) for CPU tensors, is ``kernels.ops.ssd_scan``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import launch

# The kernels of one call, in launch order; each is named ``ssd_*``.
KERNELS = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")
# Launch counts: calls, and launches of each kernel; one per launch the
# wrapper makes, and nowhere else.
LAUNCHES = {"ssd_scan": 0, **{k: 0 for k in KERNELS}}

# The kernels' limits (ssd::kMaxChunk, ssd::kMaxState): chunks of at most
# 256 positions and states of at most 256 (shared memory).
MAX_CHUNK = 256
MAX_STATE = 256

_LIB = {}
_VP, _I = ctypes.c_void_p, ctypes.c_int
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# ssd_scan(stream, dtype, x, dt, A, B, C, D, init_state, y, final_state,
#          states, cum_last, b, L, H, P, G, N, Q) -> a CUDA error code
SIGNATURE = [_VP, _I] + [_VP] * 11 + [_I] * 7


def _library() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/ssd_scan.cu``."""
    lib = _LIB.get("ssd_scan")
    if lib is None:
        from . import build
        lib = build.load("ssd_scan")
        lib.ssd_scan.argtypes = SIGNATURE
        lib.ssd_scan.restype = _I
        lib.ssd_scan_error_string.argtypes = [_I]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _LIB["ssd_scan"] = lib
    return lib


def check_operands(x, dt, A, B, C, D, chunk: int,
                   init_state: Optional[torch.Tensor]) -> None:
    """What the kernels take: x (b, l, h, p); dt (b, l, h); A and D (h,);
    B and C (b, l, g, n) with g | h and n <= 256; init_state None or
    (b, h, p, n); x, B and C all f32 or all bf16, the rest f32;
    1 <= chunk <= 256; all on one device."""
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (b, l, h, p), got"
                         f" {tuple(x.shape)}")
    b, l, h, p = x.shape
    if B.dim() != 4 or C.shape != B.shape or B.shape[:2] != (b, l):
        raise ValueError(f"ssd_scan: B and C must be (b, l, g, n) with x's"
                         f" (b, l), got {tuple(B.shape)}, {tuple(C.shape)}")
    g, n = B.shape[2], B.shape[3]
    if g < 1 or h % g != 0:
        raise ValueError(f"ssd_scan: {g} groups do not divide {h} heads")
    if dt.shape != (b, l, h) or A.shape != (h,) or D.shape != (h,):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)}, A {tuple(A.shape)}"
                         f" and D {tuple(D.shape)} do not fit x"
                         f" {tuple(x.shape)}")
    if init_state is not None and init_state.shape != (b, h, p, n):
        raise ValueError(f"ssd_scan: init_state {tuple(init_state.shape)} is"
                         f" not {(b, h, p, n)}")
    if min(b, l, p, n) < 1 or not 1 <= chunk <= MAX_CHUNK \
            or n > MAX_STATE:
        raise ValueError(f"ssd_scan: empty operand, chunk {chunk} outside"
                         f" [1, {MAX_CHUNK}] or state {n} above {MAX_STATE}")
    if x.dtype not in _DTYPE_CODE or not x.dtype == B.dtype == C.dtype:
        raise TypeError(f"ssd_scan: x, B and C must be all f32 or all bf16,"
                        f" got {x.dtype}, {B.dtype}, {C.dtype}")
    rest = (dt, A, D) + (() if init_state is None else (init_state,))
    for t in (B, C) + rest:
        if t.device != x.device:
            raise ValueError("ssd_scan: operands lie on different devices")
    for t in rest:
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: dt, A, D and init_state must be f32,"
                            f" got {t.dtype}")


def ssd_scan_plain(x, dt, A, B, C, D, chunk: int,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' plain version: ``ssd_chunked`` on x, B and C widened
    to f32, y rounded once to x's dtype."""
    from ..models.mamba import ssd_chunked
    check_operands(x, dt, A, B, C, D, chunk, init_state)
    y, final = ssd_chunked(x.float(), dt, A, B.float(), C.float(), D, chunk,
                           init_state=init_state)
    return y.to(x.dtype), final


def ssd_scan(x, dt, A, B, C, D, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the three kernels on CUDA tensors -> (y (b, l, h, p) in x's
    dtype, final state (b, h, p, n) f32).  Raises for tensors not on a
    CUDA device and for a failed launch."""
    check_operands(x, dt, A, B, C, D, chunk, init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan kernel: tensors on {x.device}, not on a"
                         f" CUDA device")
    x, dt, B, C = (t.contiguous() for t in (x, dt, B, C))
    A, D = A.contiguous(), D.contiguous()
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = min(chunk, l)
    nc = -(-l // q)
    init = None if init_state is None else init_state.contiguous()
    y = torch.empty_like(x)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    states = torch.empty((b, nc, h, p, n), dtype=torch.float32,
                         device=x.device)
    cum_last = torch.empty((b, h, nc), dtype=torch.float32, device=x.device)
    lib = _library()
    rc = launch.on_stream(
        x.get_device(), lib.ssd_scan, _DTYPE_CODE[x.dtype], x.data_ptr(),
        dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
        None if init is None else init.data_ptr(), y.data_ptr(),
        final.data_ptr(), states.data_ptr(), cum_last.data_ptr(), b, l, h,
        p, g, n, q)
    LAUNCHES["ssd_scan"] += 1
    for k in KERNELS:
        LAUNCHES[k] += 1
    if rc != 0:
        msg = lib.ssd_scan_error_string(rc).decode()
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {rc} ({msg})")
    return y, final
