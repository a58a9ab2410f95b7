"""Gradient bucketing: the analogue of the paper's message aggregation.

The port's counterpart of the JAX package's ``core/bucketing.py``.  A
list of gradient leaves is packed into flat *buckets* no larger than
``aggr_bytes`` (the analogue of MPICH's ``MPIR_CVAR_PART_AGGR_SIZE``,
§3.2.1 -- an upper bound: leaves are merged while they fit; a leaf larger
than the threshold forms its own bucket, it is never split).  One
collective is issued per bucket instead of per leaf.  Aggregation and
channel assignment come from :func:`repro_torch.core.commplan.plan_sized`.

A *leaf* is a tensor, or a list of tensors (*segments*) that the JAX
package stacks on a leading layer axis: segment ``i`` is layer ``i``'s
slice, so the list ravels exactly like the stacked array.  Packing and
unpacking go through the hand-written kernels (``kernels.ops``); the
port works in place where the JAX package returns new arrays:
:func:`bucketed_apply` writes the reduced buckets back into the leaves.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch

from ..kernels import ops
from . import commplan

Leaf = Union[torch.Tensor, Sequence[torch.Tensor]]


@dataclass(frozen=True)
class Bucket:
    leaf_ids: Tuple[int, ...]     # indices into the flattened leaf list
    sizes: Tuple[int, ...]        # element counts per leaf
    nbytes: int
    channel: int = 0              # round-robin VCI-analogue tag


@dataclass(frozen=True)
class BucketPlan:
    buckets: Tuple[Bucket, ...]
    n_leaves: int

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def total_bytes(self) -> int:
        return sum(b.nbytes for b in self.buckets)


def segments(leaf: Leaf) -> List[torch.Tensor]:
    """The segments of a leaf: the tensor itself, or its layer slices."""
    return [leaf] if isinstance(leaf, torch.Tensor) else list(leaf)


def leaf_count(leaf: Any) -> int:
    """Element count of a leaf or of a shape carrier (anything with
    ``shape``; scalars count as one)."""
    if hasattr(leaf, "shape"):
        n = 1
        for d in leaf.shape:
            n *= int(d)
        return n
    return sum(leaf_count(s) for s in leaf)


def leaf_nbytes(leaf: Any) -> int:
    """Payload bytes of a leaf or shape carrier: the one sizing rule of
    the bucket planner."""
    dtype = leaf.dtype if hasattr(leaf, "dtype") else segments(leaf)[0].dtype
    return leaf_count(leaf) * dtype.itemsize


def make_plan(leaves: Sequence[Any], aggr_bytes,
              n_channels: int = 1) -> BucketPlan:
    """Aggregate leaves (or shape/dtype carriers) into buckets via
    CommPlan.

    ``aggr_bytes="auto"`` asks the :mod:`repro_torch.core.planner`
    autotuner to pick the aggregation bound (and, with
    ``n_channels="auto"``, the channel count) from the closed-form model
    on the reference's TPU-targeted :class:`~repro_torch.core.fabric
    .NetConfig` (``planner.TPU_NET``), so the plan equals the JAX
    package's — the self-configuring analogue of tuning
    ``MPIR_CVAR_PART_AGGR_SIZE`` per workload.
    """
    counts = [leaf_count(leaf) for leaf in leaves]
    nbytes = [leaf_nbytes(leaf) for leaf in leaves]
    if aggr_bytes == "auto" or n_channels == "auto":
        from . import planner
        desc = planner.gradient_desc(float(sum(nbytes)))
        choice = planner.choose_plan(desc, approaches=("part",))
        if aggr_bytes == "auto":
            aggr_bytes = int(choice.aggr_bytes)
        if n_channels == "auto":
            n_channels = choice.n_vcis
    plan = commplan.plan_sized(nbytes, aggr_bytes=aggr_bytes,
                               n_channels=n_channels)
    buckets = tuple(
        Bucket(leaf_ids=msg.items,
               sizes=tuple(counts[i] for i in msg.items),
               nbytes=int(msg.nbytes),
               channel=msg.channel)
        for msg in plan.messages)
    return BucketPlan(buckets, len(leaves))


def _bucket_segments(leaves: Sequence[Leaf], bucket: Bucket
                     ) -> List[torch.Tensor]:
    return [s for i in bucket.leaf_ids for s in segments(leaves[i])]


def pack(leaves: Sequence[Leaf], bucket: Bucket,
         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Concatenate the bucket's leaves into one flat vector, in
    ``dtype`` or else the promoted dtype of the leaves (as
    ``jnp.concatenate`` promotes)."""
    segs = _bucket_segments(leaves, bucket)
    if dtype is None:
        dtype = segs[0].dtype
        for s in segs[1:]:
            dtype = torch.promote_types(dtype, s.dtype)
    return ops.bucket_pack(segs, dtype)


def unpack(flat: torch.Tensor, bucket: Bucket, templates: Sequence[Leaf],
           out: Optional[Sequence[Leaf]] = None) -> List[List[torch.Tensor]]:
    """Slice a flat bucket back into the bucket's leaves, shaped and
    typed like ``templates``: one list of segments per leaf.  With
    ``out`` (leaves indexed like ``templates``) the pieces are written
    into ``out``'s segments in place."""
    tmpl = [segments(templates[i]) for i in bucket.leaf_ids]
    dst = None if out is None else _bucket_segments(out, bucket)
    pieces = ops.bucket_unpack(flat, [s for t in tmpl for s in t], dst)
    res, k = [], 0
    for t in tmpl:
        res.append(pieces[k:k + len(t)])
        k += len(t)
    return res


def _covering_view(segs: Sequence[torch.Tensor]) -> Optional[torch.Tensor]:
    """One flat view over ``segs`` when they are consecutive contiguous
    slices of one tensor (a stacked leaf's gradient buffer), else None."""
    base, first = segs[0]._base, segs[0]
    off = first.storage_offset()
    for s in segs:
        if (base is None or s._base is not base or s.dtype != first.dtype
                or not s.is_contiguous() or s.storage_offset() != off):
            return None
        off += s.numel()
    return first.as_strided((off - first.storage_offset(),), (1,))


def bucketed_apply(leaves: Sequence[Leaf],
                   fn: Callable[[torch.Tensor, Bucket], torch.Tensor], *,
                   aggr_bytes: int, n_channels: int = 1) -> Sequence[Leaf]:
    """Apply ``fn`` (e.g. an all-reduce mean) to each packed bucket of
    ``leaves`` and write the result back into the leaves in place.

    ``fn(flat, bucket)`` returns the reduced vector (it may reduce
    ``flat`` in place and return it); a cast for the wire is ``fn``'s
    business, as in the JAX package's early-bird sync.  This is the
    workhorse of both the bulk (one large bucket) and the partitioned
    (per-layer, bounded buckets) gradient-sync modes.  ``fn`` runs once
    per bucket, as the JAX package's collective does: a single-leaf
    bucket whose leaf is one tensor, or segments that are consecutive
    slices of one buffer, is reduced in place through one view, with no
    pack and no copy; any other bucket, a stacked leaf with scattered
    segments included, is packed and unpacked.
    """
    if not leaves:
        return leaves
    plan = make_plan(leaves, aggr_bytes, n_channels)
    for bucket in plan.buckets:
        if len(bucket.leaf_ids) == 1:
            segs = segments(leaves[bucket.leaf_ids[0]])
            whole = segs[0] if len(segs) == 1 else _covering_view(segs)
            if whole is not None:
                y = fn(whole, bucket)
                if y is not whole:
                    whole.copy_(y)
                continue
        flat = fn(pack(leaves, bucket), bucket)
        unpack(flat, bucket, leaves, out=leaves)
    return leaves
