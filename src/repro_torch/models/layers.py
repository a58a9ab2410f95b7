"""Basic neural-net layers as plain functions on tensors.

The port's counterpart of the JAX package's ``models/layers.py``:
RMSNorm, soft-capping, SiLU, rotary position embeddings and the
parameter initialisers, which draw from an explicit ``torch.Generator``.
``chunked_cross_entropy`` belongs to the training slice and is not
ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6, *,
             zero_centered: bool = False) -> torch.Tensor:
    """RMSNorm with f32 accumulation; ``zero_centered`` uses ``1 + scale``
    in the parameter dtype (gemma)."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = (1.0 + scale) if zero_centered else scale
    return (x * w).to(dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 logit soft-capping: ``cap * tanh(x / cap)``."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def dense_init(gen: torch.Generator, in_dim: int, out_shape: Sequence[int],
               dtype: torch.dtype, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Truncated-normal fan-in init, shape ``(in_dim, *out_shape)``,
    drawn in f32 on the generator's device and cast to ``dtype``."""
    if scale is None:
        scale = 1.0 / math.sqrt(in_dim)
    w = torch.empty((in_dim, *out_shape), dtype=torch.float32,
                    device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (scale * w).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d_model: int,
               dtype: torch.dtype) -> torch.Tensor:
    """Std ``1/sqrt(d)``: keeps tied-head logits O(1) at init."""
    w = torch.randn((vocab, d_model), dtype=torch.float32, device=gen.device,
                    generator=gen)
    return (w / math.sqrt(d_model)).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (classic RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for half the head dim, f32."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Optional[Tuple[int, ...]] = None
               ) -> torch.Tensor:
    """Rotate ``x`` of shape ``(..., S, H, D)`` by position-dependent
    angles; ``positions`` is ``(..., S)``.  Angles are f32 and the result
    is cast back to ``x``'s dtype."""
    if mrope_sections is not None:
        raise NotImplementedError(
            "M-RoPE (qwen2-vl) is not ported yet: ROADMAP queue 1, item 7")
    half = x.shape[-1] // 2
    inv = rope_freqs(x.shape[-1], theta, device=x.device)
    ang = positions[..., None].float() * inv      # (..., S, half)
    cos = torch.cos(ang)[..., None, :]            # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
