"""Attention mixers: GQA (sliding window, softcap) and MLA, with caches.

The port's counterpart of the JAX package's ``models/attention.py``.
``masked_attention`` computes attention in query chunks (each chunk's
softmax is exact over the full key range); a GQA prefill's
self-attention over the new tokens goes through the hand-written
flash-attention kernel instead (``kernels.ops.flash_attention``), the
CUDA counterpart of the Pallas kernel that is the TPU-tiled version of
the same contraction.  MLA (multi-head latent attention, MiniCPM3 /
DeepSeek-V2 style) always takes ``masked_attention``, as in the JAX
package: its query/key head dim (``qk_nope + qk_rope``) differs from its
value head dim, which the kernel does not take.

Parameters keep the JAX shapes and names: ``wq`` is
``(d_model, H, head_dim)``, ``wk``/``wv`` ``(d_model, Hkv, head_dim)``,
``wo`` ``(H, head_dim, d_model)``; MLA's are listed on :class:`MLA`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..compat import all_gather_
from ..kernels import ops
from .tp import gather_heads
from .layers import apply_rope, dense_init, rms_norm, softcap

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
    """q: (B,Sq,H,Dk); k: (B,Sk,Kv,Dk), v: (B,Sk,Kv,Dv) with Kv | H --
    grouped products, the expanded KV is never materialized; the value
    head dim may differ from the query/key one (MLA).  Scores in f32;
    probabilities cast to ``out_dtype`` before P.V."""
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


def kv_window(head_map: Sequence[int]) -> Optional[Tuple[int, int]]:
    """(lo, hi) when a run of q heads uses the KV heads [lo, hi)
    uniformly -- q head i of the run on KV head lo + i // (its length /
    (hi - lo)) -- else None.  The whole head map of a model whose head
    count its KV heads divide gives (0, n_kv); a tensor-parallel rank's
    run (``attention_fwd``'s ``tp``) can be uniform over a subset where
    the whole map, padded, is not (llama3.2-1b's smoke config at M = 3:
    (0, 0, 1, 1, 0, 0) over all six heads, (1, 1) on rank 1)."""
    lo, hi = min(head_map), max(head_map) + 1
    n = len(head_map)
    if n % (hi - lo):
        return None
    g = n // (hi - lo)
    if any(m != lo + i // g for i, m in enumerate(head_map)):
        return None
    return lo, hi


def attention_fwd(p: Attention, x: torch.Tensor, *, positions: torch.Tensor,
                  head_map: Tuple[int, ...], window: int = 0,
                  attn_softcap: Optional[float] = None,
                  rope_theta: float = 1e4,
                  mrope_sections: Optional[Tuple[int, ...]] = None,
                  q_scale: Optional[float] = None,
                  cache: Optional[Dict[str, torch.Tensor]] = None,
                  cache_pos: Optional[int] = None, q_chunk: int = 512,
                  flash: bool = True, decode_attn=None,
                  cache_offset: Optional[int] = None, cache_group=None,
                  tp=None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """GQA attention.

    x: (B, S, D).  positions: (S,) or (B, S), or (3, S) or (3, B, S)
    for M-RoPE, whose temporal row masks the keys.  cache: {'k', 'v'}:
    (B, S_max, n_kv, head_dim) tensors, written in place at offset
    ``cache_pos``; keys are read back from the cache in its dtype.

    A prefill -- a cache written from position 0 with more than one new
    token, 1-D (temporal) positions and q heads that use their KV heads
    uniformly (:func:`kv_window`) -- runs its self-attention over the
    new tokens through the flash-attention kernel, given those KV heads
    (``flash=False`` takes ``masked_attention`` instead, the oracle of
    that choice).  A decode step -- one new token into a cache under the
    uniform head map -- goes through ``decode_attn(q (B, H, D), k, v (B,
    S, Kv, D), *, pos, window, attn_softcap, scale) -> (B, H, D)`` when
    one is given (the partitioned-KV flash decode of
    ``launch.steps.make_decode_step``); every other shape uses
    ``masked_attention``, the KV heads expanded by the head map where it
    is not uniform.

    ``cache_offset`` marks a cache split along the sequence (the
    sequence-sharded cache of ``launch.steps``): the tensors hold only
    positions [cache_offset, cache_offset + their length), and
    ``cache_group`` is the process group over that split.  The new
    tokens are written where they fall in that slice; a prefill from
    position 0 with 1-D positions attends over the new tokens as the
    cache would hold them (in its dtype), a decode step through
    ``decode_attn`` attends to the local slice (the partitioned flash
    decode; the KV heads expanded by the head map where it is not
    uniform), and every other path first gathers the whole cache over
    ``cache_group``, as GSPMD does in the JAX package.

    ``tp`` (``models.tp.TP``): this rank holds the q heads [r H/M, (r+1)
    H/M) of ``wq``/``bq`` and the same rows of ``wo``, and all the KV
    heads; the output is this rank's partial sum, which the caller
    reduces.  A decode step through ``decode_attn`` first gathers q's
    heads over the group, so every rank attends all heads over its
    cache slice (the hook's q is replicated over the sequence axes, as
    the JAX package's), then keeps its own heads for ``wo``.
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
    tpos = positions if mrope_sections is None else positions[0]

    sq, n_kv, h_local = q.shape[1], k.shape[2], q.shape[2]
    h0 = 0 if tp is None else tp.rank * h_local
    win = kv_window(head_map[h0:h0 + h_local])
    whole = kv_window(head_map) == (0, n_kv)
    hook = (decode_attn is not None and cache is not None and sq == 1
            and (whole or tp is not None or cache_offset is not None))
    if cache is not None:
        if cache_pos is None:
            raise ValueError("attention_fwd: a cache needs cache_pos")
        if cache_offset is None:
            cache["k"][:, cache_pos:cache_pos + sq] = k
            cache["v"][:, cache_pos:cache_pos + sq] = v
            k, v = cache["k"], cache["v"]
        else:
            _write_slice(cache, {"k": k, "v": v}, cache_pos, cache_offset)
            if sq > 1 and cache_pos == 0 and tpos.dim() == 1:
                k, v = k.to(cache["k"].dtype), v.to(cache["v"].dtype)
            elif hook:
                k, v = cache["k"], cache["v"]
            else:
                k, v = (gather_cache(cache[n], cache_group)
                        for n in ("k", "v"))
        q_pos = tpos if tpos.dim() >= 1 else tpos[None]
    else:
        q_pos = torch.arange(sq, device=x.device)
    k_pos = torch.arange(k.shape[1], device=x.device)

    if hook:
        q1 = q[:, 0] if tp is None else gather_heads(q[:, 0], tp)
        if not whole:
            k, v = _expand_kv(k, v, head_map)
        out = decode_attn(q1, k, v, pos=cache_pos, window=window,
                          attn_softcap=attn_softcap, scale=scale)
        out = out[:, h0:h0 + h_local]
        dt = torch.promote_types(out.dtype, p.wo.dtype)
        out = torch.einsum("bhk,hkd->bd", out.to(dt), p.wo.to(dt))
        return out[:, None, :], cache
    if (flash and cache is not None and cache_pos == 0 and sq > 1
            and tpos.dim() == 1 and win is not None):
        # keys beyond the new tokens are hidden by causality: pass [:S]
        lo, hi = win
        out = ops.flash_attention(
            q.transpose(1, 2), k[:, :sq, lo:hi].transpose(1, 2),
            v[:, :sq, lo:hi].transpose(1, 2), causal=True, window=window,
            softcap=attn_softcap, scale=scale).transpose(1, 2)
        out = out.to(torch.promote_types(q.dtype, v.dtype))
    else:
        if win is not None:
            k_att, v_att = k[:, :, win[0]:win[1]], v[:, :, win[0]:win[1]]
        else:  # non-uniform head map: expand KV by gather
            k_att, v_att = _expand_kv(k, v, head_map[h0:h0 + h_local])
        out = masked_attention(q, k_att, v_att, q_pos=q_pos, k_pos=k_pos,
                               window=window, attn_softcap=attn_softcap,
                               scale=scale, q_chunk=q_chunk)
    dt = torch.promote_types(out.dtype, p.wo.dtype)
    out = torch.einsum("bqhk,hkd->bqd", out.to(dt), p.wo.to(dt))
    return out, cache


def _expand_kv(k: torch.Tensor, v: torch.Tensor, head_map
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K and V with one head per q head of ``head_map`` (a gather)."""
    hm = torch.tensor(tuple(head_map), dtype=torch.long, device=k.device)
    return k.index_select(2, hm), v.index_select(2, hm)


def gather_cache(t: torch.Tensor, group) -> torch.Tensor:
    """The whole sequence of a sequence-split cache entry (B, S/N, ...)
    on every rank of ``group``, the N ranks' slices in order."""
    if group is None:
        raise ValueError("a sequence-split cache needs the group over its"
                         " split (cache_group) to attend to the whole"
                         " sequence")
    return all_gather_(t, 1, group)


def _write_slice(cache: Dict[str, torch.Tensor],
                 new: Dict[str, torch.Tensor], pos: int, off: int) -> None:
    """Write each of ``new``'s tokens at positions [pos, pos + S) into
    its cache slice holding positions [off, off + its length), where
    they fall in it."""
    for name, t in new.items():
        sq, n = t.shape[1], cache[name].shape[1]
        lo, hi = max(pos, off), min(pos + sq, off + n)
        if lo < hi:
            cache[name][:, lo - off:hi - off] = t[:, lo - pos:hi - pos]


# ---------------------------------------------------------------------------
# Multi-head latent attention (MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """MLA projections, allocated uninitialised (:func:`init_mla` fills
    them): the query down-projection ``w_dq`` (d, q_lora) with its norm
    ``norm_q`` and up-projection ``w_uq`` (q_lora, H, qk_nope + qk_rope);
    the KV latent ``w_dkv`` (d, kv_lora) with ``norm_kv``, expanded per
    head by ``w_uk`` (kv_lora, H, qk_nope) and ``w_uv`` (kv_lora, H,
    v_dim); the shared rope key ``w_kr`` (d, qk_rope); ``wo`` (H, v_dim,
    d)."""

    def __init__(self, *, d_model: int, n_heads_padded: int, q_lora: int,
                 kv_lora: int, qk_nope: int, qk_rope: int, v_dim: int,
                 dtype, device):
        super().__init__()

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)
        h = n_heads_padded
        self.w_dq = p(d_model, q_lora)
        self.norm_q = p(q_lora)
        self.w_uq = p(q_lora, h, qk_nope + qk_rope)
        self.w_dkv = p(d_model, kv_lora)
        self.norm_kv = p(kv_lora)
        self.w_uk = p(kv_lora, h, qk_nope)
        self.w_uv = p(kv_lora, h, v_dim)
        self.w_kr = p(d_model, qk_rope)
        self.wo = p(h, v_dim, d_model)


@torch.no_grad()
def init_mla(p: MLA, gen: torch.Generator, *, n_heads: int) -> MLA:
    """Fan-in truncated normals, unit norms; padded head slots are zero
    in ``w_uq`` and ``wo``."""
    d_model, q_lora = p.w_dq.shape
    kv_lora = p.w_dkv.shape[1]
    h_pad, v_dim = p.wo.shape[:2]
    dt = p.w_dq.dtype
    p.w_dq.copy_(dense_init(gen, d_model, (q_lora,), dt))
    p.norm_q.fill_(1.0)
    p.w_uq.copy_(dense_init(gen, q_lora, p.w_uq.shape[1:], dt))
    p.w_dkv.copy_(dense_init(gen, d_model, (kv_lora,), dt))
    p.norm_kv.fill_(1.0)
    p.w_uk.copy_(dense_init(gen, kv_lora, p.w_uk.shape[1:], dt))
    p.w_uv.copy_(dense_init(gen, kv_lora, p.w_uv.shape[1:], dt))
    p.w_kr.copy_(dense_init(gen, d_model, p.w_kr.shape[1:], dt))
    p.wo.copy_(dense_init(gen, h_pad * v_dim, (d_model,), dt)
               .reshape(h_pad, v_dim, d_model))
    if h_pad > n_heads:
        p.w_uq[:, n_heads:].zero_()
        p.wo[n_heads:].zero_()
    return p


def mla_fwd(p: MLA, x: torch.Tensor, *, positions: torch.Tensor,
            qk_nope: int, qk_rope: int, rope_theta: float = 1e4,
            window: int = 0,
            cache: Optional[Dict[str, torch.Tensor]] = None,
            cache_pos: Optional[int] = None, q_chunk: int = 512,
            cache_offset: Optional[int] = None, cache_group=None
            ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """MLA: the cache holds only the compressed latent and the shared
    rope key, ``{'ckv': (B, S_max, kv_lora), 'kr': (B, S_max,
    qk_rope)}``, written in place at ``cache_pos``.  Every call rebuilds
    the per-head keys and values from the whole latent it attends over
    (the full cache when there is one), as the JAX package does.

    Tensor parallel, this rank holds a block of the heads of ``w_uq``,
    ``w_uk`` and ``w_uv`` and the same rows of ``wo`` (the latent
    projections whole), and returns its partial sum, which the caller
    reduces.  ``cache_offset`` and ``cache_group``: a cache split along
    the sequence, as ``attention_fwd`` takes it: a prefill from position
    0 attends over its new tokens, every other call gathers the whole
    latent first."""
    scale = (qk_nope + qk_rope) ** -0.5
    cq = rms_norm(x @ p.w_dq, p.norm_q)
    q = torch.einsum("bsr,rhk->bshk", cq, p.w_uq)
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    q_rope = apply_rope(q_rope, positions, rope_theta)

    ckv = rms_norm(x @ p.w_dkv, p.norm_kv)                   # (B, S, r)
    kr = apply_rope((x @ p.w_kr)[:, :, None, :], positions,
                    rope_theta)[:, :, 0, :]                 # (B, S, rope)

    if cache is not None:
        if cache_pos is None:
            raise ValueError("mla_fwd: a cache needs cache_pos")
        s = x.shape[1]
        if cache_offset is None:
            cache["ckv"][:, cache_pos:cache_pos + s] = ckv
            cache["kr"][:, cache_pos:cache_pos + s] = kr
            ckv_att, kr_att = cache["ckv"], cache["kr"]
        else:
            _write_slice(cache, {"ckv": ckv, "kr": kr}, cache_pos,
                         cache_offset)
            if s > 1 and cache_pos == 0 and positions.dim() == 1:
                ckv_att = ckv.to(cache["ckv"].dtype)
                kr_att = kr.to(cache["kr"].dtype)
            else:
                ckv_att, kr_att = (gather_cache(cache[n], cache_group)
                                   for n in ("ckv", "kr"))
        q_pos = positions if positions.dim() >= 1 else positions[None]
    else:
        ckv_att, kr_att = ckv, kr
        q_pos = torch.arange(x.shape[1], device=x.device)
    k_pos = torch.arange(ckv_att.shape[1], device=x.device)

    dt = p.w_uk.dtype
    k_nope = torch.einsum("bsr,rhk->bshk", ckv_att.to(dt), p.w_uk)
    v = torch.einsum("bsr,rhk->bshk", ckv_att.to(dt), p.w_uv)

    # fold the shared rope key into the head dim so one attention call
    # works: scores = q_nope . k_nope + q_rope . kr
    h = q.shape[2]
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    kr_b = kr_att.to(dt)[:, :, None, :].expand(*kr_att.shape[:2], h,
                                                qk_rope)
    k_cat = torch.cat([k_nope, kr_b], dim=-1)
    out = masked_attention(q_cat, k_cat, v, q_pos=q_pos, k_pos=k_pos,
                           window=window, attn_softcap=None, scale=scale,
                           q_chunk=q_chunk)
    out = torch.einsum("bqhk,hkd->bqd", out, p.wo)
    return out, cache
