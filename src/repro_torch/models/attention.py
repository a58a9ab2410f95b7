"""GQA attention with sliding window, softcap and a KV cache.

The port's counterpart of the JAX package's ``models/attention.py``.
``masked_attention`` computes attention in query chunks (each chunk's
softmax is exact over the full key range); a prefill's self-attention
over the new tokens goes through the hand-written flash-attention kernel
instead (``kernels.ops.flash_attention``), the CUDA counterpart of the
Pallas kernel that is the TPU-tiled version of the same contraction.
MLA (``mla_fwd``/``init_mla``) is not ported yet (ROADMAP queue 1,
item 7).

Parameters keep the JAX shapes and names: ``wq`` is
``(d_model, H, head_dim)``, ``wk``/``wv`` ``(d_model, Hkv, head_dim)``,
``wo`` ``(H, head_dim, d_model)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..kernels import ops
from .layers import apply_rope, dense_init, softcap

NEG_INF = -2.3819763e38  # most-negative bf16-representable


def head_to_kv_map(n_heads: int, n_kv: int, n_heads_padded: int
                   ) -> Tuple[int, ...]:
    """Static q-head -> kv-head assignment; padded heads map to kv 0."""
    group = n_heads // n_kv
    return tuple((h // group) if h < n_heads else 0
                 for h in range(n_heads_padded))


def _mask(q_pos, k_pos, window: int):
    """Boolean (..., Sq, Sk): causal + optional sliding window
    (``window <= 0``: global)."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    m = k <= q
    if window > 0:
        m = m & ((q - k) < window)
    return m


def _attn_block(q, k, v, q_pos, k_pos, window, cap, scale, out_dtype):
    """q: (B,Sq,H,D); k/v: (B,Sk,Kv,D) with Kv | H -- grouped products,
    the expanded KV is never materialized.  Scores in f32; probabilities
    cast to ``out_dtype`` before P.V."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    scores = scores * scale
    scores = softcap(scores, cap)
    if q_pos.dim() == 1:
        m = _mask(q_pos, k_pos, window)[None, None, None]
    else:  # per-batch positions (decode)
        m = _mask(q_pos, k_pos[None, :], window)[:, None, None]
    scores = torch.where(m, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(out_dtype)
    dt = torch.promote_types(probs.dtype, v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(dt), v.to(dt))
    return out.reshape(b, sq, h, -1)


def masked_attention(q, k, v, *, q_pos, k_pos, window: int = 0,
                     attn_softcap: Optional[float] = None, scale: float,
                     q_chunk: int = 512) -> torch.Tensor:
    """q: (B,Sq,H,Dk), k: (B,Sk,Kv,Dk), v: (B,Sk,Kv,Dv), Kv | H (q head
    i attends kv head i // (H/Kv)) -> (B,Sq,H,Dv).

    Runs over query chunks; each chunk sees the full key range, so the
    softmax is exact.
    """
    b, sq, h, dk = q.shape
    if sq <= q_chunk or sq % q_chunk != 0 or q_pos.dim() > 2:
        return _attn_block(q, k, v, q_pos, k_pos, window, attn_softcap,
                           scale, q.dtype)
    outs = []
    for c in range(0, sq, q_chunk):
        pc = q_pos[c:c + q_chunk] if q_pos.dim() == 1 \
            else q_pos[:, c:c + q_chunk]
        outs.append(_attn_block(q[:, c:c + q_chunk], k, v, pc, k_pos,
                                window, attn_softcap, scale, q.dtype))
    return torch.cat(outs, dim=1)


class Attention(nn.Module):
    """GQA projections: ``wq``, ``wk``, ``wv``, ``wo`` (and the biases
    ``bq``, ``bk``, ``bv`` with ``qkv_bias``), allocated uninitialised;
    :func:`init_attention` fills them."""

    def __init__(self, *, d_model: int, n_heads_padded: int, n_kv: int,
                 head_dim: int, qkv_bias: bool, dtype, device):
        super().__init__()

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)
        self.wq = p(d_model, n_heads_padded, head_dim)
        self.wk = p(d_model, n_kv, head_dim)
        self.wv = p(d_model, n_kv, head_dim)
        self.wo = p(n_heads_padded, head_dim, d_model)
        if qkv_bias:
            self.bq = p(n_heads_padded, head_dim)
            self.bk = p(n_kv, head_dim)
            self.bv = p(n_kv, head_dim)


@torch.no_grad()
def init_attention(p: Attention, gen: torch.Generator, *, n_heads: int
                   ) -> Attention:
    """Fan-in truncated-normal weights, zero biases; padded head slots
    are zero in ``wq`` and ``wo`` so the output equals the logical
    head-count output."""
    d_model, h_pad, hd = p.wq.shape
    n_kv = p.wk.shape[1]
    dt = p.wq.dtype
    p.wq.copy_(dense_init(gen, d_model, (h_pad, hd), dt))
    p.wk.copy_(dense_init(gen, d_model, (n_kv, hd), dt))
    p.wv.copy_(dense_init(gen, d_model, (n_kv, hd), dt))
    p.wo.copy_(dense_init(gen, h_pad * hd, (d_model,), dt)
               .reshape(h_pad, hd, d_model))
    if h_pad > n_heads:
        p.wq[:, n_heads:].zero_()
        p.wo[n_heads:].zero_()
    for name in ("bq", "bk", "bv"):
        if hasattr(p, name):
            getattr(p, name).zero_()
    return p


def attention_fwd(p: Attention, x: torch.Tensor, *, positions: torch.Tensor,
                  head_map: Tuple[int, ...], window: int = 0,
                  attn_softcap: Optional[float] = None,
                  rope_theta: float = 1e4,
                  mrope_sections: Optional[Tuple[int, ...]] = None,
                  q_scale: Optional[float] = None,
                  cache: Optional[Dict[str, torch.Tensor]] = None,
                  cache_pos: Optional[int] = None, q_chunk: int = 512,
                  flash: bool = True
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """GQA attention.

    x: (B, S, D).  positions: (S,) or (B, S).  cache: {'k', 'v'}:
    (B, S_max, n_kv, head_dim) tensors, written in place at offset
    ``cache_pos``; keys are read back from the cache in its dtype.

    A prefill -- a cache written from position 0 with more than one new
    token, 1-D positions and the uniform head map -- runs its
    self-attention over the new tokens through the flash-attention
    kernel (``flash=False`` takes ``masked_attention`` instead, the
    oracle of that choice); decode and every other shape use
    ``masked_attention``.
    """
    head_dim = p.wq.shape[-1]
    scale = q_scale if q_scale is not None else head_dim ** -0.5

    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
    if hasattr(p, "bq"):
        q, k, v = q + p.bq, k + p.bk, v + p.bv

    q = apply_rope(q, positions, rope_theta, mrope_sections)
    k = apply_rope(k, positions, rope_theta, mrope_sections)

    sq = q.shape[1]
    if cache is not None:
        if cache_pos is None:
            raise ValueError("attention_fwd: a cache needs cache_pos")
        cache["k"][:, cache_pos:cache_pos + sq] = k
        cache["v"][:, cache_pos:cache_pos + sq] = v
        k, v = cache["k"], cache["v"]
        q_pos = positions if positions.dim() >= 1 else positions[None]
    else:
        q_pos = torch.arange(sq, device=x.device)
    k_pos = torch.arange(k.shape[1], device=x.device)

    n_kv = k.shape[2]
    h_padded = q.shape[2]
    uniform = (h_padded % n_kv == 0 and
               tuple(head_map) == tuple(i // (h_padded // n_kv)
                                        for i in range(h_padded)))
    if (flash and cache is not None and cache_pos == 0 and sq > 1
            and positions.dim() == 1 and uniform):
        # keys beyond the new tokens are hidden by causality: pass [:S]
        out = ops.flash_attention(
            q.transpose(1, 2), k[:, :sq].transpose(1, 2),
            v[:, :sq].transpose(1, 2), causal=True, window=window,
            softcap=attn_softcap, scale=scale).transpose(1, 2)
        out = out.to(torch.promote_types(q.dtype, v.dtype))
    else:
        if uniform:
            k_att, v_att = k, v
        else:  # non-uniform head map: expand KV by gather
            hm = torch.tensor(head_map, dtype=torch.long, device=x.device)
            k_att = k.index_select(2, hm)
            v_att = v.index_select(2, hm)
        out = masked_attention(q, k_att, v_att, q_pos=q_pos, k_pos=k_pos,
                               window=window, attn_softcap=attn_softcap,
                               scale=scale, q_chunk=q_chunk)
    dt = torch.promote_types(out.dtype, p.wo.dtype)
    out = torch.einsum("bqhk,hkd->bqd", out.to(dt), p.wo.to(dt))
    return out, cache
