"""Partition-granular ring collectives with multi-channel streams.

The port's counterpart of the JAX package's ``core/chunked_collectives.py``,
over a ``torch.distributed`` process group (``group``; None is the
default group) instead of a ``shard_map`` axis.  It exposes the paper's
two knobs that a fused all-reduce cannot express:

  * **partitioning**: a collective is decomposed into per-partition
    ring steps (``compat.ppermute``), so each partition's payload can be
    consumed the moment it arrives (collective matmul), and
  * **channels** (VCI analogue): the payload is split into
    ``n_channels`` interleaved streams, each circulating on its own
    chain of point-to-point messages under its own tag -- the
    counterpart of distinct XLA channel ids, mirroring MPICH's
    round-robin partition->VCI mapping (§3.2.2).  Every channel's hop
    is posted before any is waited on.

Also here: an int8-quantized ring all-reduce (int8 payloads and one f32
scale per hop, requantized per hop), the wire side of
``optim.grad_compress``; its scale is the reference's as XLA compiles
it (``INV_127``).

Each rank calls each function with its own shard, as each device runs
the ``shard_map`` body.  The order of every add is the reference's, so
the f32 rings are bit for bit JAX's; the two collective matmuls post
the next block's transfer before the current block's product and wait
after it.  Forward only.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..compat import axis_index, axis_size, ppermute_start
from .commplan import channel_slices


def _ring_perm(n: int, reverse: bool = False):
    if reverse:
        return [(i, (i - 1) % n) for i in range(n)]
    return [(i, (i + 1) % n) for i in range(n)]


def _split_channels(x: torch.Tensor, k: int) -> List[torch.Tensor]:
    """Split the leading dim into k interleaved streams (CommPlan
    round-robin)."""
    if k <= 1:
        return [x]
    if x.shape[0] % k:
        raise ValueError(f"{x.shape[0]} rows do not split into {k}"
                         f" channels")
    return [x[sl] for sl in channel_slices(x.shape[0], k)]


def _merge_channels(parts, k: int, axis: int = 0) -> torch.Tensor:
    """Inverse of :func:`_split_channels`: re-interleave k streams along
    ``axis``."""
    if k <= 1:
        return parts[0]
    n = sum(p.shape[axis] for p in parts)
    p0 = parts[0]
    out = torch.empty((*p0.shape[:axis], n, *p0.shape[axis + 1:]),
                      dtype=p0.dtype, device=p0.device)
    idx = [slice(None)] * out.dim()
    for sl, p in zip(channel_slices(n, k), parts):
        idx[axis] = sl
        out[tuple(idx)] = p
    return out


def _hop(blocks: List[torch.Tensor], group, perm) -> List[torch.Tensor]:
    """One ring step of every channel stream: all posted (stream c under
    tag c), then all received."""
    pending = [ppermute_start(b, group, perm, tag=c)
               for c, b in enumerate(blocks)]
    return [p.wait() for p in pending]


def _rank_order(stacked: torch.Tensor, idx: int, n: int) -> torch.Tensor:
    """``out[g] = stacked[(idx - g) % n]``: blocks received hop by hop
    (``stacked[j]`` is rank ``idx - j``'s) in global rank order."""
    order = (idx - torch.arange(n)) % n
    return stacked[order.to(stacked.device)]


def ring_all_gather(x: torch.Tensor, group=None, *, n_channels: int = 1,
                    tiled: bool = False) -> torch.Tensor:
    """All-gather via N-1 ring steps per channel stream.

    x: the local shard.  Returns (N, *x.shape) stacked in global rank
    order, or concatenated along dim 0 if ``tiled``.
    """
    n, idx = axis_size(group), axis_index(group)
    perm = _ring_perm(n)
    streams = _split_channels(x, n_channels)
    got = [[s] for s in streams]          # got[c][j]: rank (idx - j)'s
    cur = streams
    for _ in range(n - 1):
        cur = _hop(cur, group, perm)
        for c, blk in enumerate(cur):
            got[c].append(blk)
    gathered = [_rank_order(torch.stack(g), idx, n) for g in got]
    if n_channels <= 1:
        out = gathered[0]
    else:  # reassemble each gathered shard from its interleaved streams
        out = torch.stack([_merge_channels([s[g] for s in gathered],
                                           n_channels)
                           for g in range(n)])
    return out.reshape(-1, *x.shape[1:]) if tiled else out


def ring_reduce_scatter(x: torch.Tensor, group=None, *,
                        n_channels: int = 1) -> torch.Tensor:
    """Reduce-scatter via a ring: x is (N, chunk, ...) of local
    contributions in global order; returns this rank's reduced chunk.

    The partial for block b is created at rank b+1 (each rank r starts
    with its contribution to block r-1) and travels N-1 hops; after hop
    s, rank r holds the partial for block r-s-1 and adds its local
    contribution after the received partial.  After N-1 hops rank r
    holds block r, reduced over all ranks.  Channels split the chunk
    dim (dim 1)."""
    n, idx = axis_size(group), axis_index(group)
    perm = _ring_perm(n)
    k = max(1, n_channels)
    parts = ([x] if k == 1 else
             [x[:, sl] for sl in channel_slices(x.shape[1], k)])
    acc = [p[(idx - 1) % n] for p in parts]
    for s in range(1, n):
        acc = _hop(acc, group, perm)
        acc = [a + p[(idx - s - 1) % n] for a, p in zip(acc, parts)]
    return _merge_channels(acc, k, axis=0)


def ring_all_reduce(x: torch.Tensor, group=None, *, n_channels: int = 1
                    ) -> torch.Tensor:
    """All-reduce = reduce-scatter + all-gather over flat chunks (padded
    with zeros to a multiple of ``N * n_channels``)."""
    n = axis_size(group)
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % (n * max(1, n_channels))
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    chunks = flat.reshape(n, -1)
    mine = ring_reduce_scatter(chunks, group, n_channels=n_channels)
    full = ring_all_gather(mine, group, n_channels=n_channels, tiled=True)
    full = full.reshape(-1)
    if pad:
        full = full[:-pad]
    return full.reshape(x.shape)


# The reference's ``max(|v|, 1e-30) / 127.0`` as XLA compiles it inside
# shard_map: a division by a constant becomes a multiply by its float32
# reciprocal (an ulp from the true quotient in about 4 % of scales).
INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _q8(v: torch.Tensor):
    """One f32 scale ``max(|v|, 1e-30) * float32(1/127)`` and ``round(v
    / scale)`` in int8, as the reference runs them.  The factor and the
    divisor are tensors on ``v``'s device: CUDA divides by a host scalar
    as a multiply by its reciprocal, which would move the quotients by
    an ulp against the CPU and JAX."""
    inv = torch.full((), INV_127, dtype=torch.float32, device=v.device)
    scale = torch.clamp_min(v.abs().amax(), 1e-30) * inv
    return torch.round(v / scale).to(torch.int8), scale


def _dq8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ring_all_reduce_q8(x: torch.Tensor, group=None) -> torch.Tensor:
    """Int8-compressed ring all-reduce: each hop ships int8 payloads and
    one f32 scale (4x fewer wire bytes than f32), requantizing per hop.

    Lossy; the error is bounded by the per-hop quantization step.  See
    ``optim.grad_compress`` for the error-feedback wrapper.
    """
    n, idx = axis_size(group), axis_index(group)
    perm = _ring_perm(n)
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    chunks = flat.reshape(n, -1)

    def send(qv, sc):
        """One hop of a payload and its scale (two messages)."""
        pq = ppermute_start(qv, group, perm, tag=0)
        ps = ppermute_start(sc, group, perm, tag=1)
        return pq.wait(), ps.wait()

    # reduce-scatter with quantized payloads
    acc = chunks[(idx - 1) % n].to(torch.float32)
    for s in range(1, n):
        qv, sc = send(*_q8(acc))
        acc = _dq8(qv, sc) + chunks[(idx - s - 1) % n].to(torch.float32)
    # all-gather the reduced chunks, quantized
    qv, sc = _q8(acc)
    blocks = [(qv, sc)]
    for _ in range(n - 1):
        qv, sc = send(qv, sc)
        blocks.append((qv, sc))
    stacked = torch.stack([_dq8(b, s) for b, s in blocks])
    full = _rank_order(stacked, idx, n).reshape(-1)
    if pad:
        full = full[:-pad]
    return full.reshape(x.shape).to(x.dtype)


def collective_ag_matmul(x_shard: torch.Tensor, w: torch.Tensor,
                         group=None) -> torch.Tensor:
    """Overlapped all-gather + matmul (the serve-side early-bird
    pattern).

    Computes ``all_gather(x) @ w`` but consumes each arriving shard at
    once: at every ring step the next block's transfer is posted, the
    block in hand is multiplied, and only then is the transfer waited
    on -- the MPI_Parrived-style per-partition consumption of §2.3.1.

    x_shard: (rows_local, K); w: (K, N), replicated.  Returns
    (N_ranks * rows_local, N) in global row order, in x's dtype.
    """
    n, idx = axis_size(group), axis_index(group)
    perm = _ring_perm(n)
    rows = x_shard.shape[0]
    out = torch.empty((n * rows, w.shape[1]), dtype=x_shard.dtype,
                      device=x_shard.device)
    cur = x_shard
    for j in range(n):
        src = (idx - j) % n  # whose shard we currently hold
        nxt = ppermute_start(cur, group, perm) if j != n - 1 else None
        out[src * rows:(src + 1) * rows] = cur @ w
        if nxt is not None:
            cur = nxt.wait()
    return out


def collective_matmul_rs(x: torch.Tensor, w_shard: torch.Tensor,
                         group=None) -> torch.Tensor:
    """Overlapped matmul + reduce-scatter.

    Each rank holds a K-shard of w (row-sharded contraction); the
    partial product is reduce-scattered over rows block by block, the
    partial of one block in flight while the next block's product is
    computed.

    x: (M, K_local); w_shard: (K_local, N).  Returns this rank's
    (M / N_ranks, N) block of the reduced product (row blocks in rank
    order).
    """
    n, idx = axis_size(group), axis_index(group)
    perm = _ring_perm(n)
    m = x.shape[0]
    if m % n:
        raise ValueError(f"{m} rows do not split over {n} ranks")
    rows = m // n

    def block(i):  # partial product of row-block i
        return x[i * rows:(i + 1) * rows] @ w_shard

    acc = block((idx - 1) % n)
    for s in range(1, n):
        pending = ppermute_start(acc, group, perm)
        mine = block((idx - s - 1) % n)
        acc = pending.wait() + mine
    return acc
