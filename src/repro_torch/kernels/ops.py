"""Public wrappers of the port's kernels.

Counterpart of the JAX package's ``kernels/ops.py``.  Each wrapper takes
its kernel's plain version for tensors on the CPU and launches the
hand-written kernel for tensors on a CUDA device; there it either runs
the kernel or raises, and never falls back.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from . import bucket_pack as _bp
from . import flash_attention as _fa
from . import quant8 as _q8


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None):
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D) with Hkv | H ->
    (B, H, Sq, D) in q's dtype; ``scale`` defaults to ``D**-0.5``."""
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window, softcap=softcap,
                                         scale=scale)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale)


def bucket_pack(leaves: Sequence[torch.Tensor],
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Flatten, cast to ``out_dtype`` (default: the first leaf's) and
    concatenate f32/bf16 leaves into one flat bucket."""
    if leaves and leaves[0].is_cpu:
        return _bp.bucket_pack_plain(leaves, out_dtype)
    return _bp.bucket_pack(leaves, out_dtype)


def bucket_unpack(flat: torch.Tensor, templates: Sequence[torch.Tensor],
                  out: Optional[Sequence[torch.Tensor]] = None
                  ) -> List[torch.Tensor]:
    """Split a flat bucket into pieces shaped and typed like
    ``templates``; written into ``out`` in place when given."""
    if flat.is_cpu:
        return _bp.bucket_unpack_plain(flat, templates, out)
    return _bp.bucket_unpack(flat, templates, out)


def quantize_blockwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat x -> (int8 values of len(x), f32 scales per 256-block)."""
    if x.device.type == "cpu":
        return _q8.quantize_blockwise_plain(x)
    return _q8.quantize_blockwise(x)


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor
                         ) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise`; f32 of len(q)."""
    if q.device.type == "cpu":
        return _q8.dequantize_blockwise_plain(q, scales)
    return _q8.dequantize_blockwise(q, scales)
