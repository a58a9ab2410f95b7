"""Flash attention: the wrapper of the hand-written CUDA kernel in
``csrc/flash_attention.cu`` and the kernel's plain PyTorch version.

Counterpart of the JAX package's ``kernels/flash_attention.py``, whose
Pallas kernel (``_kernel``, launched by ``flash_attention``) this kernel
replaces.  On the H100 the function is bound by tensor-core FLOPs at
serving shapes (a causal prefill of 1024 tokens does about 4 * S * D / 2
multiply-adds for every element of q it reads); this first kernel is
SIMT f32 on the CUDA cores and leaves the tensor cores unused, which a
later version fixes with TMA-staged tiles and ``wgmma`` products
(ROADMAP queue 2).  The kernel masks ragged tails itself, so the host
pads nothing; the plain version pads to the kernel's block multiples
and masks the padded keys by the true key length, as the Pallas kernel
does.

:func:`flash_attention` launches the kernel for CUDA tensors only; the
public entry point that takes the plain version for CPU tensors is
``kernels.ops.flash_attention``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import ref

# Block sizes of csrc/flash_attention.cu (kBlockQ, kBlockK).
BLOCK_Q = 64
BLOCK_K = 64
MAX_HEAD_DIM = 256

# Launch count of the kernel: one per launch the wrapper makes, and
# nowhere else.
LAUNCHES = {"flash_attention": 0}

_LIB = {}
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DTYPES = (torch.float32, torch.bfloat16)


def _library() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/flash_attention.cu``."""
    lib = _LIB.get("flash_attention")
    if lib is None:
        from . import build
        lib = build.load("flash_attention")
        for fn in (lib.flash_attention_f32, lib.flash_attention_bf16):
            fn.argtypes = [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _F, _F]
            fn.restype = _I
        lib.flash_attention_error_string.argtypes = [_I]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB["flash_attention"] = lib
    return lib


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                   ) -> None:
    """Shapes, dtypes and devices the kernel takes: q (B, H, Sq, D),
    k and v (B, Hkv, Sk, D) with Hkv | H, D a multiple of 8 up to 256,
    f32 or bf16, all on one device."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: need q (B, H, Sq, D) and k, v"
                         f" (B, Hkv, Sk, D), got {tuple(q.shape)},"
                         f" {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    bk, hkv, sk, dk = k.shape
    if bk != b or dk != d or hkv < 1 or h % hkv != 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k"
                         f" {tuple(k.shape)} disagree (batch, head dim, or"
                         f" Hkv not dividing H)")
    if d % 8 != 0 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} is not a multiple"
                         f" of 8 in [8, {MAX_HEAD_DIM}]")
    if sq < 1 or sk < 1:
        raise ValueError("flash_attention: empty query or key sequence")
    for t in (q, k, v):
        if t.dtype not in _DTYPES:
            raise TypeError(f"flash_attention: dtype {t.dtype} is not f32"
                            f" or bf16")
        if t.device != q.device:
            raise ValueError("flash_attention: q, k and v lie on different"
                             " devices")


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's plain version: :func:`ref.flash_attention_ref` on q
    and k/v padded to the kernel's block multiples, the padded keys
    masked by the true key length and the padded rows cut off."""
    check_operands(q, k, v)
    sq, sk = q.shape[2], k.shape[2]
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    pq, pk = (-sq) % BLOCK_Q, (-sk) % BLOCK_K
    out = ref.flash_attention_ref(
        F.pad(q, (0, 0, 0, pq)), F.pad(k, (0, 0, 0, pk)),
        F.pad(v, (0, 0, 0, pk)), causal=causal, window=window,
        softcap=softcap, scale=scale, valid_len=sk)
    return out[:, :, :sq]


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: q (B, H, Sq, D), k and v
    (B, Hkv, Sk, D) -> (B, H, Sq, D) in q's dtype.  Operands of mixed
    dtype run in the widest of them (exact: the kernel computes in f32)
    and the output is rounded to q's dtype.  Raises for tensors that are
    not on a CUDA device and for a failed launch."""
    check_operands(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel: tensors on {q.device},"
                         f" not on a CUDA device")
    dtype = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                v.dtype)
    q_, k_, v_ = (t.to(dtype).contiguous() for t in (q, k, v))
    b, h, sq, d = q_.shape
    hkv, sk = k_.shape[1], k_.shape[2]
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q_)
    lib = _library()
    fn = (lib.flash_attention_f32 if dtype == torch.float32
          else lib.flash_attention_bf16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(stream, q_.data_ptr(), k_.data_ptr(), v_.data_ptr(),
                out.data_ptr(), b, h, hkv, sq, sk, d, int(causal),
                int(window), int(softcap is not None),
                float(softcap or 0.0), float(scale))
    LAUNCHES["flash_attention"] += 1
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}"
                           f" ({msg})")
    return out.to(q.dtype)
