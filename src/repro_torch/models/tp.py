"""The tensor-, expert- and sequence-parallel forward: its context and
its collectives.

The JAX package has no such module: it lays the parameters out by
``lm.param_specs`` and lets GSPMD insert the collectives the layout
needs.  The port has no GSPMD, so this module (the name is the port's
own) holds what GSPMD writes there.  A :class:`TP` context names the
process group over the mesh's ``model`` axis, its size M and this rank's
index r; the model code takes its blocks from it:

  * q heads (GQA and MLA) and experts: the rank-th of M equal blocks
    (``ModelConfig.with_tp`` pads both to a multiple of M);
  * the vocabulary of the embedding and the head: the same (padded);
  * the Mamba mixer's d_inner channels: the rank-th of M equal blocks,
    as the JAX package places them, which may start or end inside a
    head (``models.mamba.mamba_fwd`` runs the heads its block touches;
    the steps refuse an M that does not divide d_inner, as JAX's
    ``device_put`` does);
  * the dense FFN's hidden units: ``torch.chunk``'s rule, a block of
    ceil(n / M) each and the last ones shorter, so a width M does not
    divide still splits (``launch.mesh.block``).

The collectives are ``torch.autograd.Function`` s, so that a training
step can reuse them: :func:`enter` (identity forward, all-reduce
backward) at the input of a column-parallel region, :func:`reduce`
(all-reduce forward, identity backward) at the output of a row-parallel
one, :func:`psum` (all-reduce both ways: a sum every rank reads, as the
gated norm's sums of squares), :func:`gather_seq` and
:func:`scatter_seq` (all-gather and reduce-scatter along the sequence:
the sequence-parallel residual stream), :func:`gather_vocab` and
:func:`gather_heads` (all-gather along the vocabulary or the heads,
backward keeps this rank's block).  All
of them go through ``repro_torch.compat``, whose ``CALLS`` counts them.

Training (``launch.steps.make_train_step`` on a mesh) runs the same
forward and these backwards, under one rule: every rank computes the
same loss (the vocab-parallel cross entropy sums its blocks with
:func:`reduce`, whose backward passes the gradient through), so a
region's input gradient is each rank's partial, summed by
:func:`enter`'s or :func:`gather_seq`'s backward (never both: under
sequence parallelism a mixer's input is gathered, not entered), and
each rank owns its block of a sequence-split stream.  The gathers of
:func:`gather_vocab`, :func:`gather_heads` and :func:`gather_rows` keep
this rank's block in backward, right where every rank reads the
gathered tensor alike (serving).  What GSPMD adds in the JAX package
and these do not: the gradient of a replicated leaf read inside a
region (``wk``, the MLA latent, Mamba's B/C/dt, the router; under
sequence parallelism the stream norms) is a partial sum on each rank
(``lm.partial_grad_leaves``); the step adds them over ``model`` in
buckets after backward (``core.earlybird.model_axis_sum``).  A step's
collectives over ``model`` (``compat.CALLS``), with remat: each
region's entry and exit both ways, the forward's again in backward's
recomputation up to a layer's last saved tensor (so not a layer's last
output unless a post norm reads it), the gated norm's sums both ways,
two all-reduces a loss chunk and again in its recomputation, one a
bucket of the gradient sum and one for the clip norm
(``optim.adamw.global_norm``); ``tests/test_torch_tp_train.py`` counts
them per family.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import compat
from ..compat import all_gather_, psum_, reduce_scatter_
from ..launch.mesh import axis_group, axis_index, block, model_size


@dataclass(frozen=True)
class TP:
    """This rank's place in the tensor-parallel group: ``group`` (the
    process group over the mesh's ``model`` axis), its ``size`` M and
    this rank's ``rank`` r there; ``seq_parallel``: keep the residual
    stream of a prefill split along the sequence between layers;
    ``rows_group``: the group over the data axes when they split the
    batch's rows (None when every rank runs every row), over which the
    MoE layers gather the rows so that routing and capacity see the
    whole batch, as the JAX package's global view does."""
    group: object
    size: int
    rank: int
    seq_parallel: bool = False
    rows_group: object = None

    def block(self, n: int) -> slice:
        """This rank's block of a dim of ``n`` (``launch.mesh.block``)."""
        return block(n, self.size, self.rank)

    def splits_seq(self, s: int) -> bool:
        """True when a stream of ``s`` positions is sequence-parallel:
        ``seq_parallel`` on, more than one rank, and ``s`` a multiple of
        M (the JAX package's ``_seq_shard_fn`` rule; a decode step's one
        position never splits)."""
        return self.seq_parallel and self.size > 1 and s % self.size == 0 \
            and s >= self.size


def from_mesh(mesh, seq_parallel: bool = False, rows_axes=None) -> TP:
    """The context of this rank on ``mesh`` (``launch.mesh``);
    ``rows_axes``: the axes that split the batch's rows, if any."""
    return TP(group=axis_group(mesh, "model"), size=model_size(mesh),
              rank=axis_index(mesh, "model"), seq_parallel=seq_parallel,
              rows_group=None if rows_axes is None
              else axis_group(mesh, rows_axes))


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of every rank's ``x``, out of place (``x``
    itself on a group of one rank, the call still counted)."""
    if compat.axis_size(group) == 1:
        return psum_(x, group)
    return psum_(x.contiguous().clone(), group)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.group), None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_(g, 1, ctx.group), None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_scatter_(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_(g, 1, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, dim):
        ctx.n, ctx.rank, ctx.dim = x.shape[dim], rank, dim
        return all_gather_(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None


def enter(x: torch.Tensor, tp: Optional[TP]) -> torch.Tensor:
    """Identity; backward all-reduces the gradient over the group (the
    input of a column-parallel region, which every rank reads)."""
    return x if tp is None else _Enter.apply(x, tp.group)


def reduce(x: torch.Tensor, tp: Optional[TP]) -> torch.Tensor:
    """The sum of every rank's partial ``x`` (the output of a
    row-parallel product); backward passes the gradient through."""
    return x if tp is None else _Reduce.apply(x, tp.group)


def psum(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """The sum of every rank's ``x``, which every rank then reads with
    its own block (backward sums the gradients too)."""
    return _Psum.apply(x, tp.group)


def gather_seq(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """(B, S/M, ...) blocks -> (B, S, ...) on every rank."""
    return _GatherSeq.apply(x, tp.group)


def scatter_seq(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """Partial (B, S, ...) -> this rank's (B, S/M, ...) block of the
    sum (a reduce-scatter)."""
    return _ScatterSeq.apply(x, tp.group)


def gather_vocab(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """(..., V/M) blocks -> (..., V) on every rank, in rank order."""
    return _Gather.apply(x, tp.group, tp.rank, x.dim() - 1)


def gather_heads(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """(B, H/M, ...) blocks of the q heads -> (B, H, ...) on every rank,
    in the global head order."""
    return _Gather.apply(x, tp.group, tp.rank, 1)


def gather_rows(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """(B/N, ...) rows of the data ranks -> (B, ...) on every rank (the
    inverse: ``x[r B/N:(r+1) B/N]`` on data rank r)."""
    return _Gather.apply(x, tp.rows_group, compat.axis_index(tp.rows_group), 0)


def reduce_out(x: torch.Tensor, tp: Optional[TP], split: bool
               ) -> torch.Tensor:
    """A row-parallel output: reduce-scattered along the sequence when
    the stream is ``split`` (sequence parallel), else all-reduced."""
    if tp is None:
        return x
    return scatter_seq(x, tp) if split else reduce(x, tp)
