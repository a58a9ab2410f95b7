"""Public wrappers of the port's kernels.

Counterpart of the JAX package's ``kernels/ops.py``.  Each wrapper takes
its kernel's plain version for tensors on the CPU and launches the
hand-written kernel for tensors on a CUDA device; there it either runs
the kernel or raises, and never falls back.

A ``FakeTensor`` (``torch._subclasses.fake_tensor``: shapes without
storage, as the dry run ``launch.dryrun`` traces a step) takes a third
route, and only a FakeTensor takes it: a ``torch.library`` custom op
whose fake implementation returns outputs of the kernel's shapes and
dtypes, so that a traced step's op stream holds the kernel as one op
(``repro_torch::bucket_pack`` and so on) where a real run launches it.
Flash attention goes through its custom op on every device, because
its FLOPs are counted by a formula (:func:`_flash_flops`, registered
with ``torch.utils.flop_counter``): ``FlopCounterMode`` then counts the
kernel's launch, its plain version and its fake route alike, as
4 * B * H * Sq * Sk * D, as torch counts ``scaled_dot_product_attention``
(no discount for the causal mask or the window).  The custom op's real
implementation is the dispatch above, unchanged.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from . import bucket_pack as _bp
from . import flash_attention as _fa
from . import quant8 as _q8


def _fake(t: torch.Tensor) -> bool:
    return isinstance(t, FakeTensor)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int, softcap: Optional[float],
              scale: Optional[float]) -> torch.Tensor:
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window, softcap=softcap,
                                         scale=scale)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale)


@_flash_op.register_fake
def _(q, k, v, causal, window, softcap, scale):
    _fa.check_operands(q, k, v)
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, *args, **kwargs) -> int:
    """QK^T and PV over every (query, key) pair: 4 * B * H * Sq * Sk * D."""
    b, h, sq, d = q_shape
    return 4 * b * h * sq * k_shape[2] * d


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None):
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D) with Hkv | H ->
    (B, H, Sq, D) in q's dtype; ``scale`` defaults to ``D**-0.5``."""
    return _flash_op(q, k, v, causal, window,
                     None if softcap is None else float(softcap),
                     None if scale is None else float(scale))


@torch.library.custom_op("repro_torch::bucket_pack", mutates_args=())
def _pack_op(leaves: List[torch.Tensor],
             out_dtype: torch.dtype) -> torch.Tensor:
    return bucket_pack(leaves, out_dtype)


@_pack_op.register_fake
def _(leaves, out_dtype):
    return leaves[0].new_empty(sum(t.numel() for t in leaves),
                               dtype=out_dtype)


def bucket_pack(leaves: Sequence[torch.Tensor],
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Flatten, cast to ``out_dtype`` (default: the first leaf's) and
    concatenate f32/bf16 leaves into one flat bucket."""
    if leaves and _fake(leaves[0]):
        return _pack_op(list(leaves), out_dtype or leaves[0].dtype)
    if leaves and leaves[0].is_cpu:
        return _bp.bucket_pack_plain(leaves, out_dtype)
    return _bp.bucket_pack(leaves, out_dtype)


@torch.library.custom_op("repro_torch::bucket_unpack", mutates_args=("out",))
def _unpack_op(flat: torch.Tensor, out: List[torch.Tensor]) -> None:
    bucket_unpack(flat, out, out)


@_unpack_op.register_fake
def _(flat, out):
    return None


def bucket_unpack(flat: torch.Tensor, templates: Sequence[torch.Tensor],
                  out: Optional[Sequence[torch.Tensor]] = None
                  ) -> List[torch.Tensor]:
    """Split a flat bucket into pieces shaped and typed like
    ``templates``; written into ``out`` in place when given."""
    if _fake(flat):
        out = list(out) if out is not None else [
            flat.new_empty(t.shape, dtype=t.dtype) for t in templates]
        _unpack_op(flat, out)
        return out
    if flat.is_cpu:
        return _bp.bucket_unpack_plain(flat, templates, out)
    return _bp.bucket_unpack(flat, templates, out)


@torch.library.custom_op("repro_torch::quantize_blockwise", mutates_args=())
def _quantize_op(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return quantize_blockwise(x)


@_quantize_op.register_fake
def _(x):
    return (x.new_empty(x.shape, dtype=torch.int8),
            x.new_empty(_q8.n_blocks(x.numel()), dtype=torch.float32))


def quantize_blockwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat x -> (int8 values of len(x), f32 scales per 256-block)."""
    if _fake(x):
        return _quantize_op(x)
    if x.device.type == "cpu":
        return _q8.quantize_blockwise_plain(x)
    return _q8.quantize_blockwise(x)


@torch.library.custom_op("repro_torch::dequantize_blockwise",
                         mutates_args=())
def _dequantize_op(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return dequantize_blockwise(q, scales)


@_dequantize_op.register_fake
def _(q, scales):
    return q.new_empty(q.shape, dtype=torch.float32)


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor
                         ) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise`; f32 of len(q)."""
    if _fake(q):
        return _dequantize_op(q, scales)
    if q.device.type == "cpu":
        return _q8.dequantize_blockwise_plain(q, scales)
    return _q8.dequantize_blockwise(q, scales)
