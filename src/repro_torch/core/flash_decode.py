"""Partitioned-KV decode attention (flash decode with an LSE combine).

The port's counterpart of the JAX package's ``core/flash_decode.py``:
the inference-side incarnation of partitioned communication.  The KV
cache is the *global buffer*, split along the sequence axis over the
ranks of a process group.  Each rank computes attention of the
(replicated, tiny) query against its KV partition -- a partial output
plus softmax statistics -- and the partitions are combined with three
small collectives (one max, two sums) instead of gathering the cache:
O(H * head_dim) bytes a step, not O(S * head_dim).

The products take f32 operands, the counterpart of JAX's
``preferred_element_type=float32`` (a product of two bf16 values is
exact in f32).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..compat import axis_index, pmax_, psum_
from ..models.layers import softcap

NEG_INF = -2.3819763e38
# Keys a P.V partial product covers on a long partition (see _pv).
PV_CHUNK = 1024

Window = Union[int, torch.Tensor]


def _valid(k_pos: torch.Tensor, pos, window: Window) -> torch.Tensor:
    """Keys at or before ``pos`` and, with ``window > 0``, within it;
    ``window`` may be a per-layer tensor, as JAX's traced scalar."""
    valid = k_pos <= pos
    if isinstance(window, torch.Tensor):
        return valid & ((window <= 0) | ((pos - k_pos) < window))
    if window > 0:
        valid = valid & ((pos - k_pos) < window)
    return valid


def _scores(q, k, pos, window, attn_softcap, scale, k_pos):
    """Scaled, softcapped f32 scores (B, Kv, G, S) of q against k at key
    positions ``k_pos``, masked keys at NEG_INF, and the mask."""
    b, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, kv, h // kv, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    scores = softcap(scores, attn_softcap)
    valid = _valid(k_pos, pos, window)[None, None, None, :]
    return torch.where(valid, scores, NEG_INF), valid


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``einsum("bkgs,bskd->bkgd", p, v)`` in f32, as partial products
    over runs of ``PV_CHUNK`` keys summed afterwards where the partition
    holds two runs or more.  One product over a long partition has G
    rows and S-long dot products, which cuBLAS spreads over a handful of
    blocks: on the H100 it takes about ten times as long as the runs at
    S 131072 (``chip_smoke.py`` phase 19b times both).  The sums
    associate differently, so the result moves by f32 rounding only."""
    b, kv, g, s = p.shape
    runs = s // PV_CHUNK
    if runs < 2:
        return torch.einsum("bkgs,bskd->bkgd", p, v)
    n = runs * PV_CHUNK
    out = torch.einsum(
        "bkgcs,bcskd->bkcgd", p[..., :n].reshape(b, kv, g, runs, PV_CHUNK),
        v[:, :n].reshape(b, runs, PV_CHUNK, kv, v.shape[-1])).sum(dim=2)
    if n < s:
        out = out + torch.einsum("bkgs,bskd->bkgd", p[..., n:], v[:, n:])
    return out


def flash_decode_shard(q: torch.Tensor, k_shard: torch.Tensor,
                       v_shard: torch.Tensor, *, group=None, pos,
                       window: Window = 0,
                       attn_softcap: Optional[float] = None,
                       scale: float) -> torch.Tensor:
    """One-token GQA attention against a sequence-split KV cache.

    Every rank of ``group`` (None: the default group) calls it with the
    same q and its own partition, the rank-th of equal sequence slices.
    q: (B, H, D); k_shard/v_shard: (B, S_local, Kv, D), Kv | H.
    pos: the current position (keys at global index > pos are masked).
    Returns (B, H, D) in q's dtype, the same on every rank.  Issues
    three ``all_reduce`` calls: the row maxima (MAX), then the
    normalisers and the unnormalised outputs (SUM).
    """
    b, h, d = q.shape
    s_local = k_shard.shape[1]
    k_pos = axis_index(group) * s_local + torch.arange(
        s_local, device=k_shard.device)
    scores, valid = _scores(q, k_shard, pos, window, attn_softcap, scale,
                            k_pos)
    m = pmax_(scores.amax(dim=-1), group)                 # (B, Kv, G)
    p = torch.exp(scores - m[..., None])
    p = torch.where(valid, p, 0.0)
    l_sum = psum_(p.sum(dim=-1), group)
    o = psum_(_pv(p, v_shard.to(torch.float32)), group)
    out = o / torch.clamp_min(l_sum, 1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     pos, window: Window = 0,
                     attn_softcap: Optional[float] = None,
                     scale: float) -> torch.Tensor:
    """Single-device oracle (the full KV): q (B, H, D), k/v (B, S, Kv,
    D); one softmax and one P.V product, as the reference's."""
    b, h, d = q.shape
    k_pos = torch.arange(k.shape[1], device=k.device)
    scores, _ = _scores(q, k, pos, window, attn_softcap, scale, k_pos)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.to(torch.float32))
    return out.reshape(b, h, d).to(q.dtype)
