"""Gradient compression with error feedback.

The port's counterpart of the JAX package's ``optim/grad_compress.py``,
over dicts of named tensors instead of pytrees.  Pairs with the int8
ring all-reduce (``core.chunked_collectives.ring_all_reduce_q8``): the
quantization residual is fed back into the next step's gradient so the
compression error stays bounded instead of accumulating -- the standard
EF-SGD construction.

Every division takes a tensor on the leaf's device: CUDA divides by a
host scalar as a multiply by its reciprocal, which would move the
scale by an ulp against the CPU and JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch


def init_error_feedback(params) -> Dict[str, torch.Tensor]:
    """Zero f32 residuals shaped as ``params`` (a mapping of names to
    tensors, or a module's named parameters), on their devices."""
    if hasattr(params, "named_parameters"):
        params = dict(params.named_parameters())
    return {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for name, p in params.items()}


def quantize_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-leaf int8 quantization: (q int8, scale), the scale
    ``max(|g|, 1e-30) / 127`` in g's dtype."""
    d127 = torch.full((), 127.0, dtype=g.dtype, device=g.device)
    scale = torch.clamp_min(g.abs().amax(), 1e-30) / d127
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(grads: Mapping[str, torch.Tensor],
                           ef_state: Mapping[str, torch.Tensor]
                           ) -> Tuple[Dict[str, torch.Tensor],
                                      Dict[str, torch.Tensor]]:
    """Returns (quantized-view grads, new error-feedback state).

    The 'transmitted' gradient is dequantize(quantize(g + e)) in g's
    dtype; the new residual (f32) is what was lost.  Callers replace
    their gradients with the transmitted version so every DP rank
    applies identical updates.
    """
    sent, new_ef = {}, {}
    for name, g in grads.items():
        corrected = g.to(torch.float32) + ef_state[name]
        q, s = quantize_leaf(corrected)
        out = dequantize_leaf(q, s)
        sent[name] = out.to(g.dtype)
        new_ef[name] = corrected - out
    return sent, new_ef
