"""Decoder block: mixer (GQA attention, MLA, Mamba-2, or the hybrid of
attention and Mamba) + FFN (dense SwiGLU or MoE), with optional post
norms and zero-centred norms.

The port's counterpart of the JAX package's ``models/blocks.py``.  Each
layer is its own :class:`Block` module (the JAX package stacks layers on
a leading L axis and scans); the per-layer sliding window is an argument.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .. import telemetry
from . import tp as tpc
from .attention import MLA, Attention, attention_fwd, mla_fwd
from .layers import rms_norm, silu
from .mamba import Mamba, mamba_fwd
from .moe import MoE, moe_fwd

# The cache entries of each mixer, in the stacked cache's names.
ATTN_CACHE = ("k", "v")
MLA_CACHE = ("ckv", "kr")
MAMBA_CACHE = ("state", "conv_x", "conv_B", "conv_C")


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


class Block(nn.Module):
    """One decoder layer's parameters, as the JAX package's
    ``_init_layer`` lays them out: ``ln1``; ``attn`` (GQA or MLA) for
    the attention and hybrid mixers; ``mamba`` for the Mamba and hybrid
    mixers; ``norm_attn`` and ``norm_mamba`` (hybrid); ``ln1_post``
    (post norm); then, with an FFN, ``ln2``, ``moe`` or ``mlp`` and
    ``ln2_post`` (post norm)."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        d = cfg.d_model

        def norm():
            return nn.Parameter(torch.empty(d, dtype=dtype, device=device),
                                requires_grad=False)
        self.ln1 = norm()
        if cfg.mixer in ("attn", "hybrid"):
            if cfg.mla is not None:
                m = cfg.mla
                self.attn = MLA(d_model=d, n_heads_padded=cfg.n_heads_padded,
                                q_lora=m.q_lora, kv_lora=m.kv_lora,
                                qk_nope=m.qk_nope, qk_rope=m.qk_rope,
                                v_dim=m.v_dim, dtype=dtype, device=device)
            else:
                self.attn = Attention(
                    d_model=d, n_heads_padded=cfg.n_heads_padded,
                    n_kv=cfg.n_kv, head_dim=cfg.head_dim_,
                    qkv_bias=cfg.qkv_bias, dtype=dtype, device=device)
        if cfg.mixer in ("mamba", "hybrid"):
            self.mamba = Mamba(d, cfg.mamba, dtype=dtype, device=device)
        if cfg.mixer == "hybrid":
            self.norm_attn = norm()
            self.norm_mamba = norm()
        if cfg.post_norm:
            self.ln1_post = norm()
        if cfg.moe is not None or cfg.d_ff > 0:
            self.ln2 = norm()
            if cfg.moe is not None:
                self.moe = MoE(d, cfg.moe, dtype=dtype, device=device)
            else:
                self.mlp = MLP(d, cfg.d_ff, dtype=dtype, device=device)
            if cfg.post_norm:
                self.ln2_post = norm()


def _sub(cache: Optional[Dict[str, torch.Tensor]], names):
    return None if cache is None else {k: cache[k] for k in names}


def block_fwd(cfg, lp: Block, h: torch.Tensor, *, positions, window: int,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_pos: Optional[int] = None, flash: bool = True,
              decode_attn=None, cache_offset: Optional[int] = None,
              cache_group=None, tp=None, seq_split: bool = False
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One decoder layer.  ``cache``: this layer's views of the stacked
    cache ({'k', 'v'}, {'ckv', 'kr'} and/or the Mamba state), written in
    place.  ``decode_attn``: the GQA mixer's decode hook
    (``attention_fwd``); MLA and Mamba never take it.  ``cache_offset``
    and ``cache_group``: a cache split along the sequence
    (``attention_fwd``).  Returns (h', the layer's cache or None).

    ``tp`` (``models.tp.TP``): the layer's blocks of the mixers and the
    FFN (the MLP column-parallel in ``w_gate``/``w_up`` and
    row-parallel in ``w_down``, the MoE expert-parallel); each branch's
    partial output is all-reduced before the residual add, the hybrid's
    two in one message.  With ``seq_split`` (sequence parallel) ``h`` is
    this rank's (B, S/M, D) block of the residual stream: each normed
    input is all-gathered along the sequence before its mixer or FFN and
    the partial outputs are reduce-scattered back to blocks.  In
    training the stream-side norms (``ln1``, ``ln2``, the post norms and
    the hybrid's branch norms) then see only this rank's block of the
    sequence, so their gradients are partial sums over ``model``, which
    the train step adds (``launch.steps``); without ``seq_split`` they are
    whole on every rank."""
    zc = cfg.zero_centered_norm

    def enter(x):
        # the gather's backward reduce-scatters the ranks' partial
        # gradients, which is the sum enter's would take again
        return tpc.gather_seq(x, tp) if seq_split else tpc.enter(x, tp)
    hin = enter(rms_norm(h, lp.ln1, zero_centered=zc))
    outs = []
    if cfg.mixer in ("attn", "hybrid"):
        with telemetry.span("repro.attn"):
            a_in = telemetry.mark_in(hin, "repro.attn")
            if cfg.mla is not None:
                a_out, _ = mla_fwd(
                    lp.attn, a_in, positions=positions,
                    qk_nope=cfg.mla.qk_nope, qk_rope=cfg.mla.qk_rope,
                    rope_theta=cfg.rope_theta, window=window,
                    cache=_sub(cache, MLA_CACHE), cache_pos=cache_pos,
                    q_chunk=cfg.q_chunk, cache_offset=cache_offset,
                    cache_group=cache_group)
            else:
                a_out, _ = attention_fwd(
                    lp.attn, a_in, positions=positions,
                    head_map=cfg.head_map, window=window,
                    attn_softcap=cfg.attn_softcap,
                    rope_theta=cfg.rope_theta,
                    mrope_sections=cfg.mrope_sections, q_scale=cfg.q_scale,
                    cache=_sub(cache, ATTN_CACHE), cache_pos=cache_pos,
                    q_chunk=cfg.q_chunk, flash=flash,
                    decode_attn=decode_attn, cache_offset=cache_offset,
                    cache_group=cache_group, tp=tp)
            outs.append(telemetry.mark_out(a_out, "repro.attn"))
    if cfg.mixer in ("mamba", "hybrid"):
        with telemetry.span("repro.mamba"):
            m_out, _ = mamba_fwd(lp.mamba,
                                 telemetry.mark_in(hin, "repro.mamba"),
                                 mc=cfg.mamba, d_model=cfg.d_model,
                                 cache=_sub(cache, MAMBA_CACHE), tp=tp)
            outs.append(telemetry.mark_out(m_out, "repro.mamba"))
    if cfg.mixer == "hybrid":
        if tp is not None:  # both partial outputs in one message
            both = tpc.reduce_out(torch.cat(outs, dim=-1), tp, seq_split)
            outs = list(both.split(cfg.d_model, dim=-1))
        # Hymba: per-branch normalization, then the mean of the two
        mix = (rms_norm(outs[0], lp.norm_attn, zero_centered=zc)
               + rms_norm(outs[1], lp.norm_mamba, zero_centered=zc)) * 0.5
    else:
        mix = tpc.reduce_out(outs[0], tp, seq_split)
    if cfg.post_norm:
        mix = rms_norm(mix, lp.ln1_post, zero_centered=zc)
    h = h + mix
    if cfg.moe is not None or cfg.d_ff > 0:
        hin2 = enter(rms_norm(h, lp.ln2, zero_centered=zc))
        name = "repro.moe" if cfg.moe is not None else "repro.mlp"
        with telemetry.span(name):
            f_in = telemetry.mark_in(hin2, name)
            if cfg.moe is not None:
                f_out = moe_fwd(lp.moe, f_in, mo=cfg.moe, tp=tp)
            else:
                f_out = mlp_fwd(lp.mlp, f_in)
            f_out = telemetry.mark_out(f_out, name)
        f_out = tpc.reduce_out(f_out, tp, seq_split)
        if cfg.post_norm:
            f_out = rms_norm(f_out, lp.ln2_post, zero_centered=zc)
        h = h + f_out
    return h, cache
