"""Early-bird gradient synchronization -- the paper's technique in PyTorch.

The port's counterpart of the JAX package's ``core/earlybird.py``.  The
MPI paper's pipelined pattern: each producer marks its partition ready
and communication starts at once, overlapping the remaining compute
(Fig 2).  In data-parallel training the producers are *layers* in the
backward pass: layer L's gradient is complete while layers L-1..0 are
still computing.  The JAX package attaches a custom-VJP identity to each
scanned layer; here ``forward`` calls a *layer hook* on each layer
(``param_hook``), which registers a post-accumulate-gradient hook on the
layer's parameters.  When the last of them has its gradient, the layer's
gradient buckets are all-reduced -- inside ``backward``, while the
layers below are still computing.

Three modes mirror the paper's §2.3 taxonomy:

  * ``bulk``        -- one fused collective for the whole gradient after
                       backward (the *Pt2Pt single* analogue);
  * ``per_leaf``    -- one collective per parameter leaf (the *Pt2Pt
                       many* analogue);
  * ``partitioned`` -- per-layer collectives inside backward, aggregated
                       into buckets of at most ``aggr_bytes``.

``comm_dtype`` (e.g. ``'bfloat16'``) casts each bucket for the wire.
The data-parallel axes of the JAX package become a ``torch.distributed``
process group; its ``pmean`` becomes ``compat.psum_`` (an
``all_reduce(SUM)``, counted in ``compat.CALLS``) followed by a division
by the group's size.  Leaves follow the JAX package's order
(``models.lm.param_leaves``), so the bucket plans are the same, and
:func:`auto_sync_config` lets the planner choose the mode.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..compat import psum_
from ..models.lm import param_leaves, unread_params
from .bucketing import bucketed_apply, leaf_nbytes


@dataclass(frozen=True)
class SyncConfig:
    mode: str = "partitioned"        # bulk | per_leaf | partitioned
    group: Optional[object] = None   # process group; None = the default
    aggr_bytes: int = 4 << 20        # MPIR_CVAR_PART_AGGR_SIZE analogue
    comm_dtype: Optional[str] = None  # e.g. 'bfloat16' for compression
    n_channels: int = 1              # VCI analogue (structural tag)

    def __post_init__(self):
        if self.mode not in ("bulk", "per_leaf", "partitioned"):
            raise ValueError(f"sync mode {self.mode!r}")


@dataclass
class SyncLog:
    """What the sync issued: one ``(tag, elements)`` entry per
    all-reduce, in issue order; tags are ``"layer <i>"`` for a layer
    hook, ``"final"`` after backward and ``"loss"``."""
    entries: List[Tuple[str, int]] = field(default_factory=list)

    def count(self) -> int:
        return len(self.entries)


def _pmean_(flat: torch.Tensor, sync: SyncConfig, log: SyncLog,
            tag: str) -> torch.Tensor:
    """Mean over the group, in place on ``flat`` (cast for the wire when
    ``comm_dtype`` is set); returns the reduced tensor in ``flat``'s
    dtype."""
    x = flat
    if sync.comm_dtype is not None:
        x = flat.to(getattr(torch, sync.comm_dtype))
    psum_(x, sync.group)
    x.div_(dist.get_world_size(sync.group))
    log.entries.append((tag, x.numel()))
    if x is not flat:
        flat.copy_(x)
    return flat


def _bucketed_pmean(leaves, sync: SyncConfig, log: SyncLog, tag: str,
                    aggr_override: Optional[int] = None):
    aggr = sync.aggr_bytes if aggr_override is None else aggr_override
    return bucketed_apply(
        leaves, lambda flat, bucket: _pmean_(flat, sync, log, tag),
        aggr_bytes=aggr, n_channels=sync.n_channels)


def auto_sync_config(params, *, group: Optional[object] = None,
                     comm_dtype: Optional[str] = None,
                     tokens_per_step: float = 4096.0,
                     max_channels: int = 8,
                     workload=None, cfg=None) -> SyncConfig:
    """Model-chosen gradient-sync configuration (the autotuned analogue
    of hand-picking ``SyncConfig`` constants).

    Sizes the gradient payload from ``params`` (an ``nn.Module``, whose
    leaves are taken in the order of ``models.lm.param_leaves``, or a
    list of leaves: tensors, segment lists or shape/dtype carriers),
    describes the backward pass as a
    :func:`repro_torch.core.planner.training_workload` ramp
    (``tokens_per_step`` sets how much compute hides each gradient
    byte), and lets the planner search the (approach, aggregation,
    channels) space on the reference's TPU-targeted NetConfig
    (``planner.TPU_NET``, so the choice equals the JAX package's).  The
    chosen approach maps onto the paper's §2.3 taxonomy exactly as the
    modes do: ``pt2pt_single -> bulk``, ``pt2pt_many -> per_leaf``,
    ``part -> partitioned`` with the chosen bucket bound and channel
    count.
    """
    from . import planner

    if hasattr(params, "named_parameters"):
        params = [segs for _, segs in param_leaves(params.named_parameters())]
    total = float(sum(leaf_nbytes(x) for x in params))
    if workload is None:
        workload = planner.training_workload(2.0 * tokens_per_step)
    kw = {} if cfg is None else {"cfg": cfg}
    desc = planner.gradient_desc(total, workload=workload,
                                 max_channels=max_channels, **kw)
    choice = planner.choose_plan(desc)
    mode = {"pt2pt_single": "bulk", "pt2pt_many": "per_leaf",
            "part": "partitioned"}[choice.approach]
    aggr = int(choice.aggr_bytes) if mode == "partitioned" else \
        SyncConfig.aggr_bytes
    return SyncConfig(mode=mode, group=group, aggr_bytes=aggr,
                      comm_dtype=comm_dtype, n_channels=choice.n_vcis)


class LayerHook:
    """``param_hook`` of ``lm.forward`` in partitioned mode: called on
    each layer (outside any checkpointed region), it registers a
    post-accumulate-gradient hook on the layer's parameters; when the
    layer's last gradient is accumulated, the layer's buckets are
    all-reduced in place.  :meth:`close` removes the hooks."""

    def __init__(self, sync: SyncConfig, log: SyncLog):
        self.sync, self.log = sync, log
        self._handles: List = []
        self._pending: Dict[int, int] = {}

    def __call__(self, lp):
        i = len(self._pending)
        leaves = param_leaves(lp.named_parameters())
        params = [p for _, segs in leaves for p in segs]
        self._pending[i] = len(params)

        def ready(_p, i=i, leaves=leaves):
            self._pending[i] -= 1
            if self._pending[i] == 0:  # the layer's MPI_Pready moment
                _bucketed_pmean([[p.grad for p in segs]
                                 for _, segs in leaves],
                                self.sync, self.log, f"layer {i}")
        self._handles += [p.register_post_accumulate_grad_hook(ready)
                          for p in params]
        return lp

    def close(self) -> List[int]:
        """Remove the hooks; returns the layers that never completed."""
        for h in self._handles:
            h.remove()
        self._handles = []
        left = sorted(i for i, n in self._pending.items() if n != 0)
        self._pending = {}
        return left


def make_layer_hook(sync: SyncConfig, log: Optional[SyncLog] = None
                    ) -> Callable:
    """The layer hook of ``sync``: a :class:`LayerHook` in partitioned
    mode, the identity otherwise."""
    if sync.mode != "partitioned":
        return lambda lp: lp
    return LayerHook(sync, SyncLog() if log is None else log)


def finalize_grads(model, sync: SyncConfig, log: SyncLog,
                   layers_key: str = "layers") -> None:
    """Synchronize, in place, whatever the layer hooks did not.

    bulk:        everything, buckets of at most 256 MiB.
    per_leaf:    everything, one collective per leaf (aggr = 0).
    partitioned: only the non-layer parameters (embed/head/final_norm);
                 layer gradients were reduced inside backward.
    """
    leaves = param_leaves(model.named_parameters())
    if sync.mode == "partitioned":
        leaves = [(n, s) for n, s in leaves
                  if n.split(".")[0] != layers_key]
    grads = [[p.grad for p in segs] for _, segs in leaves]
    aggr = {"bulk": 256 << 20, "per_leaf": 0}.get(sync.mode)
    _bucketed_pmean(grads, sync, log, "final", aggr_override=aggr)


def stacked_grad_slices(model, layers_key: str = "layers"):
    """``(param, slice)`` for every layer parameter of a stacked leaf:
    one uninitialised ``[L, ...]`` buffer per leaf ``layers.<rest>``,
    layer ``i``'s parameter paired with slice ``i``."""
    for name, segs in param_leaves(model.named_parameters()):
        if name.split(".")[0] != layers_key or len(segs) < 2:
            continue
        buf = torch.empty((len(segs), *segs[0].shape), dtype=segs[0].dtype,
                          device=segs[0].device)
        yield from zip(segs, buf)


def _move_grad(p: torch.Tensor, g: torch.Tensor) -> None:
    """Post-accumulate hook: make ``p``'s gradient slice ``g``.  The
    first accumulation leaves autograd's own tensor in ``.grad``; it is
    copied into ``g`` once, and later accumulations add into ``g`` in
    place.  The test is by identity, which a fake tensor (the dry run's)
    also answers, not by address."""
    if p.grad is not g:
        g.copy_(p.grad)
        p.grad = g


def stack_layer_grads(model, layers_key: str = "layers") -> List:
    """Gather each stacked leaf's gradients into one ``[L, ...]``
    buffer as backward produces them (:func:`stacked_grad_slices`,
    :func:`_move_grad`), so that the leaf travels as one collective over
    the whole buffer, as JAX's stacked array does, instead of one per
    layer.  A parameter that backward never reaches keeps ``.grad``
    None.  Returns the hook handles; remove them after backward."""
    return [p.register_post_accumulate_grad_hook(
                lambda p, g=g: _move_grad(p, g))
            for p, g in stacked_grad_slices(model, layers_key)]


def model_axis_sum(leaf_names, group, aggr_bytes: int) -> Callable:
    """The tensor-parallel step's gradient sum over the mesh's ``model``
    axis: ``fn(model)`` adds, in place over ``group``, the gradients of
    the leaves ``leaf_names`` (``models.lm.partial_grad_leaves``: each
    rank holds a partial sum of them) in buckets of at most
    ``aggr_bytes`` (``bucketing.bucketed_apply``, so a multi-leaf bucket
    goes through the pack and unpack kernels), one all-reduce a bucket;
    ``fn.log`` is the :class:`SyncLog` of the last call (tag
    ``"model"``).  The other leaves are left alone: their gradients are
    whole, or this rank's block."""
    names = set(leaf_names)

    def fn(model) -> None:
        log = fn.log = SyncLog()
        leaves = [[p.grad for p in segs] for name, segs in
                  param_leaves(model.named_parameters()) if name in names]

        def add(flat, bucket):
            psum_(flat, group)
            log.entries.append(("model", flat.numel()))
            return flat
        bucketed_apply(leaves, add, aggr_bytes=aggr_bytes)
    fn.log = SyncLog()
    return fn


def value_and_synced_grad(loss_fn: Callable, sync: SyncConfig,
                          grad_sum: Optional[Callable] = None) -> Callable:
    """Backward + the configured gradient synchronization.

    ``loss_fn(model, *args, param_hook=...)`` must call ``param_hook``
    on each layer before running it (``lm.loss_fn`` does).  The returned
    ``wrapped(model, *args) -> (loss, grads)`` leaves the synced
    gradients in each parameter's ``.grad`` (cleared first) and returns
    them by parameter name; the loss is averaged over the group too.
    In bulk and per_leaf mode each stacked leaf's gradients end as slices
    of one buffer (:func:`stack_layer_grads`), so every bucket of the
    plan is one all-reduce.  A parameter the model's config names as
    unread (``lm.unread_params``: musicgen's ``embed``) gets a zero
    gradient, as JAX's, and is synced and updated like any other; any
    other parameter without a gradient raises.  ``grad_sum(model)``,
    when given, runs after backward and before the data-parallel sync
    of what the layer hooks left (the tensor-parallel step's
    :func:`model_axis_sum`).
    ``wrapped.log`` is the :class:`SyncLog` of the last call.
    """
    def wrapped(model, *args):
        log = SyncLog()
        wrapped.log = log
        for p in model.parameters():
            p.grad = None
        stacked = ([] if sync.mode == "partitioned"  # reduced per layer
                   else stack_layer_grads(model))
        hook = make_layer_hook(sync, log)
        try:
            val = loss_fn(model, *args, param_hook=hook)
            val.backward()
        finally:
            for h in stacked:
                h.remove()
            left = hook.close() if isinstance(hook, LayerHook) else []
        if left:
            raise RuntimeError(f"early-bird sync: layers {left} never got"
                               f" all their gradients")
        cfg = getattr(model, "cfg", None)
        for name in () if cfg is None else unread_params(cfg):
            p = model.get_parameter(name)  # JAX's gradient: zeros
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for name, p in model.named_parameters():
            if p.grad is None:
                raise RuntimeError(f"early-bird sync: {name} got no"
                                   f" gradient")
        if grad_sum is not None:
            grad_sum(model)
        finalize_grads(model, sync, log)
        val = _pmean_(val.detach().clone(), sync, log, "loss")
        return val, {n: p.grad for n, p in model.named_parameters()}

    wrapped.log = SyncLog()
    return wrapped
