"""Process-group counterparts of the shard_map collective primitives.

The JAX package runs its partitioned collectives inside ``shard_map``
over named mesh axes (``jax.lax.axis_index``, ``ppermute``, ``pmax``,
``psum``; ``repro/compat.py`` supplies ``axis_size``).  The port runs
them over a ``torch.distributed`` process group instead: a tuple of
mesh axes becomes one flat group whose rank is the row-major index
over those axes, and ``group=None`` is the default group.

``ppermute`` is one ``batch_isend_irecv`` of a send to this rank's
destination and a receive from its source under ``perm``;
:func:`ppermute_start` posts it and returns a handle, so a caller can
compute while the block is in flight.  Peers are group ranks, mapped to
global ranks when the group is not the default one.  On a group of one
rank nothing is sent (NCCL has no send to self; the JAX loops run zero
hops there).  ``pmax_`` and ``psum_`` are ``all_reduce`` in place (on a
group of one rank they count the call and send nothing).

``CALLS`` counts the collectives issued through this module
(``all_reduce``, ``ppermute``, a posted permutation counting once, and
the tensor-parallel forward's ``all_gather`` and ``reduce_scatter``
along one dim), as the kernel wrappers count their launches, and the
bytes of each call's result on this rank (``all_reduce_bytes``,
``all_gather_bytes``, ``reduce_scatter_bytes``, ``ppermute_bytes``), as
the JAX package's ``launch/hlo_analysis.py`` counts a collective by its
result shape.

This module also owns the precision switch of the torch and cuda fabric
engines, the counterpart of the JAX package's ``x64_enabled`` /
``x64_mode``: under float64 the engines are bit for bit equal to
``ReferenceFabric``; under float32 the same steps run in single
precision and are only tolerance-close (about 1e-4 relative on arrival
times), the counters (``n_messages``, ``sent_per_rank``) staying exact.
One difference from the reference: **the port defaults to float64**
(JAX defaults to float32 unless ``JAX_ENABLE_X64`` is set), because the
port's golden records are float64 and the H100 computes float64
natively.  There is no environment variable and no command-line flag:
:func:`x64_mode` is the switch.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

CALLS: Dict[str, int] = {"all_reduce": 0, "ppermute": 0,
                         "all_reduce_bytes": 0, "all_gather": 0,
                         "reduce_scatter": 0, "all_gather_bytes": 0,
                         "reduce_scatter_bytes": 0, "ppermute_bytes": 0}


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()

_X64 = [True]


def x64_enabled() -> bool:
    """True when the fabric engines compute in float64 (the default):
    bit-for-bit equality with ``ReferenceFabric``; False: float32,
    results only tolerance-close."""
    return _X64[0]


@contextlib.contextmanager
def x64_mode(enable: bool) -> Iterator[None]:
    """Context manager forcing float64 (``True``) or float32 (``False``)
    on the fabric engines for a scope; the previous mode comes back on
    exit.  The engines' operand memos are keyed by the mode, so
    switching mid-process reuses nothing made under the other mode."""
    prev = _X64[0]
    _X64[0] = bool(enable)
    try:
        yield
    finally:
        _X64[0] = prev


def axis_size(group=None) -> int:
    """Ranks in ``group`` (``jax.lax.axis_size`` of the group's axes)."""
    return dist.get_world_size(group)


def axis_index(group=None) -> int:
    """This rank's index in ``group`` (``jax.lax.axis_index``)."""
    return dist.get_rank(group)


def _global(group, rank: int) -> int:
    if group is None or group is dist.GroupMember.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


class Pending:
    """A posted permutation: :meth:`wait` returns the received tensor."""

    def __init__(self, out: torch.Tensor, works: List):
        self._out, self._works = out, works

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        self._works = []
        return self._out


def ppermute_start(x: torch.Tensor, group, perm: Sequence[Tuple[int, int]],
                   tag: int = 0) -> Pending:
    """Post ``jax.lax.ppermute(x, axis, perm)``: send ``x`` to the rank
    this one maps to and receive the block of the rank that maps here
    (a rank no pair names receives zeros, as in JAX).  ``tag`` keeps
    concurrent streams apart."""
    n, me = axis_size(group), axis_index(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute: rank {me} appears twice in {perm}")
    if n == 1:
        return Pending(x if src else torch.zeros_like(x), [])
    out = (torch.empty if src else torch.zeros)(
        x.shape, dtype=x.dtype, device=x.device)
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, x.contiguous().view(-1),
                              _global(group, dst[0]), group, tag))
    if src:
        ops.append(dist.P2POp(dist.irecv, out.view(-1),
                              _global(group, src[0]), group, tag))
    CALLS["ppermute"] += 1
    CALLS["ppermute_bytes"] += _nbytes(out)
    return Pending(out, dist.batch_isend_irecv(ops) if ops else [])


def ppermute(x: torch.Tensor, group, perm: Sequence[Tuple[int, int]],
             tag: int = 0) -> torch.Tensor:
    """``jax.lax.ppermute`` over ``group``: :func:`ppermute_start`, then
    wait."""
    return ppermute_start(x, group, perm, tag).wait()


def _all_reduce_(x: torch.Tensor, op, group) -> torch.Tensor:
    """All-reduce in place, counted; a group of one rank sends nothing
    (its sum is its own value)."""
    CALLS["all_reduce"] += 1
    CALLS["all_reduce_bytes"] += _nbytes(x)
    if axis_size(group) > 1:
        dist.all_reduce(x, op=op, group=group)
    return x


def pmax_(x: torch.Tensor, group: Optional[object] = None) -> torch.Tensor:
    """``jax.lax.pmax`` over ``group``, in place on ``x``."""
    return _all_reduce_(x, dist.ReduceOp.MAX, group)


def psum_(x: torch.Tensor, group: Optional[object] = None) -> torch.Tensor:
    """``jax.lax.psum`` over ``group``, in place on ``x``."""
    return _all_reduce_(x, dist.ReduceOp.SUM, group)


# The single-tensor collectives under their newer names where torch has
# them (the older ones warn there), else the older ones.
_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def all_gather_(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)`` over
    ``group``: every rank's block of equal shape, concatenated along
    ``dim`` in rank order."""
    n = axis_size(group)
    CALLS["all_gather"] += 1
    CALLS["all_gather_bytes"] += n * _nbytes(x)
    if n == 1:
        return x
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _GATHER(out, x, group=group)
    return out.movedim(0, dim)


def reduce_scatter_(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axis, scatter_dimension=dim,
    tiled=True)`` over ``group``: the sum over ranks, of which this rank
    keeps its block along ``dim`` (the rank-th of equal blocks)."""
    n = axis_size(group)
    CALLS["reduce_scatter"] += 1
    CALLS["reduce_scatter_bytes"] += _nbytes(x) // n
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter_: dim {dim} of {tuple(x.shape)}"
                         f" does not split over {n} ranks")
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _SCATTER(out, x, group=group)
    return out.movedim(0, dim)
