"""The yardstick: the card's published peaks, and the operations and
bytes of a step, of a prefill, of the flash kernel and of the bucket
kernels, from sizes alone.

Model FLOPs count the products the model needs once, never a
recomputation: 2 per multiply-add of every projection a token passes
through (the experts at ``top_k``, the embedding lookup none), causal
attention's QK^T and PV over the pairs (i >= j), and Mamba-2's SSD
terms at its chunk length, the intra-chunk ones over causal pairs.  A
training step is three times its forward.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

# NVIDIA H100 SXM, data sheet, dense: FLOP/s and HBM bytes/s.
PEAK = {"bf16": 989e12, "f32": 67e12, "hbm": 3.35e12}


def compute_peak(mix: dict) -> float:
    """The peak of the arithmetic a mix states: bf16, or f32 (TF32 off)."""
    return PEAK["bf16"] if mix["param_dtype"] == "bfloat16" else PEAK["f32"]


def proj_params(s) -> int:
    """Weights a token multiplies by in one layer (experts at top_k)."""
    d = s.d_model
    if s.family == "granite_moe":
        attn = d * s.n_heads * s.head_dim * 2 + 2 * d * s.n_kv * s.head_dim
        return attn + d * s.n_experts + s.top_k * 3 * d * s.d_expert
    if s.family == "mamba2":
        gn = s.n_groups * s.d_state
        return d * (2 * s.d_inner + 2 * gn + s.m_heads) + s.d_inner * d
    raise ValueError(s.family)


def causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def mixer_flops(s, batch: int, n: int) -> int:
    """Forward FLOPs of one layer's sequence mixing beyond its
    projections, over ``batch`` sequences of ``n``."""
    if s.family == "granite_moe":      # QK^T and PV, causal
        return 4 * batch * s.n_heads * s.head_dim * causal_pairs(n)
    if s.family == "mamba2":
        q, h, p, N = s.chunk, s.m_heads, s.m_head_dim, s.d_state
        full, rest = divmod(n, q)
        pairs = full * causal_pairs(q) + causal_pairs(rest)
        intra = s.n_groups * N * pairs + h * p * pairs   # C.B^T, (L*CB).X
        states = 2 * h * p * N * n                       # B^T X, C.state
        return 2 * batch * (intra + states)
    raise ValueError(s.family)


def forward_flops(s, batch: int, n: int, head_rows: int) -> int:
    """A forward pass over (batch, n) tokens, the head on ``head_rows``
    rows."""
    return (s.n_layers * (2 * proj_params(s) * batch * n
                          + mixer_flops(s, batch, n))
            + 2 * s.d_model * s.vocab * head_rows)


def train_flops(s, batch: int, n: int) -> int:
    """Model FLOPs of a training step (forward and backward, no
    recomputation)."""
    return 3 * forward_flops(s, batch, n, batch * n)


def prefill_flops(s, batch: int, n: int) -> int:
    """Model FLOPs of a prefill: every position through the layers, the
    last one through the head."""
    return forward_flops(s, batch, n, batch)


def flash_bound_s(batch: int, heads: int, kv_heads: int, n: int, d: int,
                  elem_bytes: int = 2, peak: float = PEAK["bf16"]
                  ) -> float:
    """The least time of one causal flash call: the larger of its
    QK^T and PV FLOPs at ``peak`` and q, k, v read once and o written
    once at HBM bandwidth."""
    flops = 4 * batch * heads * d * causal_pairs(n)
    nbytes = elem_bytes * batch * n * d * (2 * heads + 2 * kv_heads)
    return max(flops / peak, nbytes / PEAK["hbm"])


def leaf_bytes(s, layer: bool, elem_bytes: int = 4
               ) -> List[Tuple[str, int]]:
    """(leaf, bytes) of one layer's gradients (``layer``) or of the
    leaves outside the layers, in the order the early-bird sync takes
    them: the leaf names sorted as the JAX tree flattens."""
    from .weights import leaves
    out = []
    for lf in leaves(s):
        if lf.name.startswith("layers.") == layer:
            n = 1
            for x in lf.shape[int(layer):]:
                n *= x
            out.append((lf.name, n * elem_bytes))
    return sorted(out, key=lambda t: tuple(t[0].split(".")))


def buckets(sizes: Sequence[int], aggr_bytes: int) -> List[List[int]]:
    """Greedy aggregation in order: a bucket takes items while it stays
    within ``aggr_bytes``; a larger item is a bucket alone."""
    out: List[List[int]] = []
    cur: List[int] = []
    for b in sizes:
        if cur and sum(cur) + b > aggr_bytes:
            out.append(cur)
            cur = []
        cur.append(b)
    if cur:
        out.append(cur)
    return out


def step_sync(s, aggr_bytes: int, elem_bytes: int = 4
              ) -> Tuple[int, int, int]:
    """(all-reduces, buckets packed, bytes packed) of one partitioned
    training step on one rank: each layer's buckets as its gradients
    complete, then those of the leaves outside the layers, then the
    loss; a bucket of more than one leaf goes through the pack and
    unpack kernels."""
    def plan(layer):
        return buckets([n for _, n in leaf_bytes(s, layer, elem_bytes)],
                       aggr_bytes)
    groups = [plan(True)] * s.n_layers + [plan(False)]
    packed = [sum(b) for g in groups for b in g if len(b) > 1]
    return sum(len(g) for g in groups) + 1, len(packed), sum(packed)


def pack_bound_s(nbytes: int) -> float:
    """Pack then unpack of ``nbytes`` of buckets: each reads and writes
    every byte once."""
    return 4 * nbytes / PEAK["hbm"]
