"""Decoder block: GQA attention + dense SwiGLU FFN, with optional post
norms and zero-centred norms.

The port's counterpart of the JAX package's ``models/blocks.py``.  Each
layer is its own :class:`Block` module (the JAX package stacks layers on
a leading L axis and scans); the per-layer sliding window is an argument.
Mamba, MoE, hybrid and MLA blocks are not ported yet (ROADMAP queue 1,
item 7) and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .attention import Attention, attention_fwd
from .layers import rms_norm, silu


class MLP(nn.Module):
    """SwiGLU weights ``w_gate``, ``w_up`` (d, d_ff) and ``w_down``
    (d_ff, d), allocated uninitialised."""

    def __init__(self, d_model: int, d_ff: int, *, dtype, device):
        super().__init__()

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)
        self.w_gate = p(d_model, d_ff)
        self.w_up = p(d_model, d_ff)
        self.w_down = p(d_ff, d_model)


def mlp_fwd(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP."""
    return (silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down


def unsupported(cfg) -> Optional[str]:
    """Why ``cfg``'s block is not ported yet, or None when it is."""
    if cfg.mixer != "attn":
        return f"mixer {cfg.mixer!r} (Mamba / hybrid)"
    if cfg.mla is not None:
        return "MLA attention"
    if cfg.moe is not None:
        return "MoE FFN"
    if cfg.mrope_sections is not None:
        return "M-RoPE"
    if cfg.frontend != "tokens":
        return f"frontend {cfg.frontend!r}"
    return None


class Block(nn.Module):
    """One decoder layer's parameters: ``ln1``, ``attn``, ``ln1_post``
    (post norm), ``ln2``, ``mlp``, ``ln2_post`` (post norm)."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        why = unsupported(cfg)
        if why is not None:
            raise NotImplementedError(
                f"{cfg.name}: {why} is not ported yet (ROADMAP queue 1,"
                f" item 7)")
        d = cfg.d_model

        def norm():
            return nn.Parameter(torch.empty(d, dtype=dtype, device=device),
                                requires_grad=False)
        self.ln1 = norm()
        self.attn = Attention(d_model=d, n_heads_padded=cfg.n_heads_padded,
                              n_kv=cfg.n_kv, head_dim=cfg.head_dim_,
                              qkv_bias=cfg.qkv_bias, dtype=dtype,
                              device=device)
        if cfg.post_norm:
            self.ln1_post = norm()
        if cfg.d_ff > 0:
            self.ln2 = norm()
            self.mlp = MLP(d, cfg.d_ff, dtype=dtype, device=device)
            if cfg.post_norm:
                self.ln2_post = norm()


def block_fwd(cfg, lp: Block, h: torch.Tensor, *, positions, window: int,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_pos: Optional[int] = None, flash: bool = True
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One decoder layer.  ``cache``: this layer's {'k', 'v'} views,
    written in place.  Returns (h', the layer's cache or None)."""
    zc = cfg.zero_centered_norm
    hin = rms_norm(h, lp.ln1, zero_centered=zc)
    mix, cache = attention_fwd(
        lp.attn, hin, positions=positions, head_map=cfg.head_map,
        window=window, attn_softcap=cfg.attn_softcap,
        rope_theta=cfg.rope_theta, mrope_sections=cfg.mrope_sections,
        q_scale=cfg.q_scale, cache=cache, cache_pos=cache_pos,
        q_chunk=cfg.q_chunk, flash=flash)
    if cfg.post_norm:
        mix = rms_norm(mix, lp.ln1_post, zero_centered=zc)
    h = h + mix
    if cfg.d_ff > 0:
        hin2 = rms_norm(h, lp.ln2, zero_centered=zc)
        f_out = mlp_fwd(lp.mlp, hin2)
        if cfg.post_norm:
            f_out = rms_norm(f_out, lp.ln2_post, zero_centered=zc)
        h = h + f_out
    return h, cache
