"""Basic neural-net layers as plain functions on tensors.

The port's counterpart of the JAX package's ``models/layers.py``:
RMSNorm, soft-capping, SiLU, rotary position embeddings (classic and
Qwen2-VL's multimodal M-RoPE), the parameter
initialisers, which draw from an explicit ``torch.Generator``, and the
chunked cross entropy of training.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint

from ..compat import pmax_
from . import tp as tpc


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6, *,
             zero_centered: bool = False, sum_sq=None,
             width: int = 0) -> torch.Tensor:
    """RMSNorm with f32 accumulation; ``zero_centered`` uses ``1 + scale``
    in the parameter dtype (gemma).

    The partial-sum form, for a normalised dim split over ranks: ``x``
    and ``scale`` are this rank's block of the dim, ``sum_sq`` sums the
    blocks' f32 sums of squares (``models.tp.psum``) and ``width`` is the
    whole dim's size, the mean's divisor."""
    dtype = x.dtype
    x = x.float()
    if sum_sq is None:
        var = x.square().mean(dim=-1, keepdim=True)
    else:
        var = sum_sq(x.square().sum(dim=-1, keepdim=True)) / width
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
# Rotary position embeddings (classic + multimodal M-RoPE)
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
    angles.  ``positions``: ``(..., S)`` for classic RoPE, or ``(3, ...,
    S)`` for Qwen2-VL M-RoPE, in which case ``mrope_sections`` splits the
    D/2 frequency slots into (temporal, height, width) groups, each
    driven by its own position row.  Angles are f32 and the result is
    cast back to ``x``'s dtype."""
    half = x.shape[-1] // 2
    inv = rope_freqs(x.shape[-1], theta, device=x.device)
    if mrope_sections is None:
        ang = positions[..., None].float() * inv  # (..., S, half)
    else:
        assert positions.dim() >= 2 and positions.shape[0] == 3, (
            "M-RoPE expects positions shaped (3, ..., S)")
        assert sum(mrope_sections) == half, (mrope_sections, half)
        ang_all = positions[..., None].float() * inv  # (3, ..., S, half)
        chunks, off = [], 0
        for i, sec in enumerate(mrope_sections):
            chunks.append(ang_all[i, ..., off:off + sec])
            off += sec
        ang = torch.cat(chunks, dim=-1)           # (..., S, half)
    cos = torch.cos(ang)[..., None, :]            # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Cross entropy, chunked over the sequence to bound logit memory
# ---------------------------------------------------------------------------

def _chunk_loss(h, y, m, head, final_softcap, valid_vocab, gather_targets,
                tp=None):
    """(sum of masked token losses, sum of the mask) of one chunk.

    Under ``tp`` (``models.tp.TP``, more than one rank) ``head`` is this
    rank's block of the vocabulary: the log-sum-exp takes the maximum of
    the blocks' detached maxima (``pmax_``) and the sum of their
    ``exp(l - max)``, and the target's logit is read on the rank whose
    block holds it; both sums are ``models.tp.reduce`` (all-reduce
    forward, identity backward: every rank computes the same loss)."""
    v = head.shape[-1]
    logits = torch.einsum("bsd,dv->bsv", h.float(), head.float())
    logits = softcap(logits, final_softcap)
    lo = 0 if tp is None else tp.rank * v
    vids = torch.arange(lo, lo + v, device=logits.device)
    if valid_vocab is not None and valid_vocab < lo + v:
        logits = torch.where(vids < valid_vocab, logits, -torch.inf)
    if gather_targets and tp is None:
        tgt = torch.gather(logits, -1, y[..., None].long())[..., 0]
    elif gather_targets:  # this block's targets; the others read 0
        idx = y[..., None].long() - lo
        mine = (idx >= 0) & (idx < v)
        tgt = torch.gather(logits, -1, idx.clamp(0, v - 1))
        tgt = torch.where(mine, tgt, 0.0)[..., 0]
    else:
        # select and reduce instead of a gather (the JAX package's
        # default: it keeps a vocab-sharded logits chunk sharded)
        tgt = torch.where(vids == y[..., None], logits, 0.0).sum(dim=-1)
    if tp is None:
        lse = torch.logsumexp(logits, dim=-1)
    else:
        mx = pmax_(logits.detach().amax(dim=-1).contiguous(), tp.group)
        se = torch.exp(logits - mx[..., None]).sum(dim=-1)
        se, tgt = tpc.reduce(torch.stack([se, tgt]), tp).unbind(0)
        lse = torch.log(se) + mx
    return ((lse - tgt) * m).sum(), m.sum()


def chunked_cross_entropy(hidden: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int = 512,
                          final_softcap: Optional[float] = None,
                          mask: Optional[torch.Tensor] = None,
                          valid_vocab: Optional[int] = None,
                          gather_targets: bool = False,
                          tp=None) -> torch.Tensor:
    """Mean CE of ``hidden @ head`` vs labels without materializing
    (B, S, V).

    hidden: (B, S, D); head: (D, V); labels: (B, S) int.  The (B, chunk,
    V) f32 logits exist one chunk at a time: each chunk runs under
    ``torch.utils.checkpoint``, so backward recomputes its logits instead
    of keeping them.  The chunk sums are added in sequence order, then
    the ragged remainder, as the JAX package's scan does.  ``valid_vocab``
    masks logit columns at or beyond it (vocab padding).

    Vocab parallel, under ``tp`` of more than one rank: ``head`` is this
    rank's (D, V/M) block of the padded vocabulary and ``hidden`` the
    whole sequence, read by every rank (its gradient is each rank's
    partial, summed by the caller's ``models.tp.enter`` or
    ``gather_seq``); each chunk's logits are this block's, in the same
    chunks and order (:func:`_chunk_loss`), and a checkpointed chunk
    recomputes its two all-reduces in backward.  A group of one rank
    takes the unsharded path.
    """
    if tp is not None and tp.size == 1:
        tp = None
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    n_chunks = s // chunk
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=hidden.device)
    args = (head, final_softcap, valid_vocab, gather_targets, tp)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        l, n = torch.utils.checkpoint.checkpoint(
            _chunk_loss, hidden[:, sl], labels[:, sl], mask[:, sl], *args,
            use_reentrant=False)
        tot, cnt = tot + l, cnt + n
    if s > n_chunks * chunk:
        rem = s - n_chunks * chunk
        l, n = _chunk_loss(hidden[:, -rem:], labels[:, -rem:],
                           mask[:, -rem:], *args)
        tot, cnt = tot + l, cnt + n
    return tot / cnt.clamp_min(1.0)
