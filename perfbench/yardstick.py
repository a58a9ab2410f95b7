"""The yardstick: the card's published peaks, and the operations and
bytes of a step, of a prefill, of the flash kernel and of the bucket
kernels, from sizes alone.

Model FLOPs count the products the model needs once, never a
recomputation: 2 per multiply-add of every projection a token passes
through (the experts at ``top_k``, the embedding lookup none), causal
attention's QK^T and PV over the pairs (i >= j), and Mamba-2's SSD
terms at its chunk length, the intra-chunk ones over causal pairs: each
family gives its layer ``i``'s terms (``families/<family>.py``), and a
forward pass sums them over the layers.  A training step is three times
its forward.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

from .families import family

# NVIDIA H100 SXM, data sheet, dense: FLOP/s and HBM bytes/s.
PEAK = {"bf16": 989e12, "f32": 67e12, "hbm": 3.35e12}


def compute_peak(mix: dict) -> float:
    """The peak of the arithmetic a mix states: bf16, or f32 (TF32 off)."""
    return PEAK["bf16"] if mix["param_dtype"] == "bfloat16" else PEAK["f32"]


def _alike(s, term) -> int:
    """``term(i)``, the same for every layer ``i`` of ``s``."""
    got = {term(i) for i in range(s.n_layers)}
    if len(got) != 1:
        raise ValueError(f"the layers of {s.name} differ: {sorted(got)}")
    return got.pop()


def proj_params(s) -> int:
    """Weights a token multiplies by in one layer (experts at top_k), of
    a model whose layers are all alike."""
    fam = family(s.family)
    return _alike(s, lambda i: fam.proj_params(s, i))


def causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def mixer_flops(s, batch: int, n: int) -> int:
    """Forward FLOPs of one layer's sequence mixing beyond its
    projections, over ``batch`` sequences of ``n``, of a model whose
    layers are all alike."""
    fam = family(s.family)
    return _alike(s, lambda i: fam.mixer_flops(s, i, batch, n))


def forward_flops(s, batch: int, n: int, head_rows: int) -> int:
    """A forward pass over (batch, n) tokens, each layer's projections
    and sequence mixing, the head on ``head_rows`` rows."""
    fam = family(s.family)
    return (sum(2 * fam.proj_params(s, i) * batch * n
                + fam.mixer_flops(s, i, batch, n)
                for i in range(s.n_layers))
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


def leaf_bytes(s, layer: Optional[int], elem_bytes: int = 4
               ) -> List[Tuple[str, int]]:
    """(leaf, bytes) of layer ``layer``'s gradients, or of the leaves
    outside the layers (``None``), in the order the early-bird sync
    takes them: the leaf names sorted as the JAX tree flattens."""
    from .weights import layer_slots, leaves
    slots = layer_slots(s)
    out = []
    for lf in leaves(s):
        if lf.per_layer and layer in slots[lf.name]:
            out.append((lf.name, math.prod(lf.shape[1:]) * elem_bytes))
        elif not lf.per_layer and layer is None:
            out.append((lf.name, math.prod(lf.shape) * elem_bytes))
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
    groups = [plan(i) for i in range(s.n_layers)] + [plan(None)]
    packed = [sum(b) for g in groups for b in g if len(b) > 1]
    return sum(len(g) for g in groups) + 1, len(packed), sum(packed)


def pack_bound_s(nbytes: int) -> float:
    """Pack then unpack of ``nbytes`` of buckets: each reads and writes
    every byte once."""
    return 4 * nbytes / PEAK["hbm"]
