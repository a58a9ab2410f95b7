"""Plain reference of a Granite-MoE decoder (GQA attention with rotary
positions, top-k routed SwiGLU experts with capacity), in f32.

The model as the configuration file states it: pre-norm blocks,
``h += attn(norm(h))``, ``h += moe(norm(h))``, a final norm and the head
(the embedding's transpose when tied).  Attention scores are scaled by
the attention multiplier.  Routing: each token's router logits (a
product in the stated precision, like every projection) pick its
``top_k`` experts, its gates the softmax of those logits; the
tokens are routed ``dispatch_chunk`` at a time (one chunk when the
token count is not a multiple of it), and in each chunk an expert takes
at most ``capacity`` of the tokens routed to it, the earliest first;
a token's slot past that adds nothing.  Weights are the stacked leaves
of ``weights.py``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .common import at, linear, rms_norm, rope, silu


def capacity(s, n_tokens: int) -> int:
    return max(s.min_capacity, int(math.ceil(
        n_tokens * s.top_k / s.n_experts * s.capacity_factor)))


def attention(s, W: Dict, i: int, x: torch.Tensor, precision: str
              ) -> torch.Tensor:
    """Causal GQA self-attention of layer ``i`` over x (B, S, d)."""
    b, n, d = x.shape
    h, kv, hd = s.n_heads, s.n_kv, s.head_dim
    w = lambda name: at(s, W, f"layers.attn.{name}", i)   # noqa: E731
    q = linear(x, w("wq").reshape(d, h * hd), precision)
    k = linear(x, w("wk").reshape(d, kv * hd), precision)
    v = linear(x, w("wv").reshape(d, kv * hd), precision)
    pos = torch.arange(n, device=x.device)
    q = rope(q.reshape(b, n, h, hd), pos, s.rope_theta).transpose(1, 2)
    k = rope(k.reshape(b, n, kv, hd), pos, s.rope_theta).transpose(1, 2)
    v = v.reshape(b, n, kv, hd).transpose(1, 2)
    k = k.repeat_interleave(h // kv, dim=1)          # q head -> kv head
    v = v.repeat_interleave(h // kv, dim=1)
    # query blocks keep the (B, H, block, S) scores near 1 GiB
    blk = max(64, min(n, (1 << 28) // max(1, b * h * n)))
    out = []
    for q0 in range(0, n, blk):
        sc = (q[:, :, q0:q0 + blk] @ k.transpose(-1, -2)) * s.attn_scale
        qi = torch.arange(q0, min(n, q0 + blk), device=x.device)
        sc = sc.masked_fill(pos[None, :] > qi[:, None], float("-inf"))
        out.append(torch.softmax(sc, dim=-1) @ v)
    o = torch.cat(out, dim=2).transpose(1, 2).reshape(b, n, h * hd)
    return linear(o, w("wo").reshape(h * hd, d), precision)


def moe(s, W: Dict, i: int, x: torch.Tensor, precision: str
        ) -> torch.Tensor:
    """Routed experts of layer ``i`` over x (B, S, d)."""
    b, n, d = x.shape
    xt = x.reshape(b * n, d)
    t = xt.shape[0]
    chunk = min(s.dispatch_chunk, t)
    if t % chunk:
        chunk = t
    router = at(s, W, "layers.moe.router", i)
    wg, wu, wd = (at(s, W, f"layers.moe.{k}", i)
                  for k in ("w_gate", "w_up", "w_down"))
    outs = []
    for c0 in range(0, t, chunk):
        xc = xt[c0:c0 + chunk]
        tc = xc.shape[0]
        logits = linear(xc, router, precision)
        top_v, top_e = torch.topk(logits, s.top_k, dim=-1)
        gates = torch.softmax(top_v, dim=-1)
        cap = capacity(s, tc)
        # slots (token, j) by expert, each expert's in token order
        flat_e = top_e.reshape(-1)
        order = torch.sort(flat_e, stable=True).indices
        counts = torch.bincount(flat_e, minlength=s.n_experts).tolist()
        y = torch.zeros_like(xc, dtype=torch.float32)
        start = 0
        for e, cnt in enumerate(counts):
            slots = order[start:start + min(cnt, cap)]
            start += cnt
            if slots.numel() == 0:
                continue
            tok = slots // s.top_k
            xe = xc[tok]
            he = silu(linear(xe, wg[e], precision)) \
                * linear(xe, wu[e], precision)
            ye = linear(he, wd[e], precision)
            y.index_add_(0, tok, ye * gates.reshape(-1)[slots, None])
        outs.append(y)
    return torch.cat(outs).reshape(b, n, d)


def layer(s, W: Dict, i: int, h: torch.Tensor, precision: str
          ) -> torch.Tensor:
    h = h + attention(s, W, i, rms_norm(h, at(s, W, "layers.ln1", i),
                                        s.eps), precision)
    return h + moe(s, W, i, rms_norm(h, at(s, W, "layers.ln2", i), s.eps),
                   precision)


def head(s, W: Dict) -> torch.Tensor:
    return W["embed"].T if s.tie else W["head"]
