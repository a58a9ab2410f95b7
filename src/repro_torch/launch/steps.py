"""Step functions (train, prefill, decode), one device per rank.

The port's counterpart of the JAX package's ``launch/steps.py``.
``StepConfig`` keeps the training and serving fields; the steps are
plain callables.  ``make_train_step`` runs the loss, backward with the
early-bird gradient sync over a ``torch.distributed`` process group
(each rank holding one card and its share of the batch), the schedule
and AdamW.  ``make_prefill_step`` and ``make_decode_step`` check their
inputs and run ``lm.prefill`` / ``lm.decode_step``; with
``StepConfig.flash_decode`` the decode step's attention is the
partitioned-KV flash decode over a process group
(``core.flash_decode``), each rank attending to its slice of the
sequence.

On a mesh (``launch.mesh``, ``mesh=``), as the JAX package lays out its
steps: the early-bird sync runs over the data axes, each rank takes its
data index's rows of the global batch, and the AdamW moments are ZeRO-1
over every axis (``optim.adamw.zero1_update``); the decode cache is placed by
:func:`_cache_shardings` (batch over the data axes and sequence over
``model``, or every axis given to the sequence when the batch does not
split; the Mamba state's heads and ``conv_x``'s channels over
``model``), so each rank holds only its block.  The serving steps run
the tensor- and expert-parallel forward (``models.tp``) over the
``model`` axis, at ``cfg.with_tp(M)`` as the JAX package's: each rank
passes its block of every parameter leaf (``lm.param_blocks``;
``models.convert.tp_params_from_jax`` or ``tp_shard_model`` make it),
and with ``StepConfig.seq_parallel`` a prefill whose length splits over
the M ranks keeps its residual stream split along the sequence.  The
train step runs the same forward and its backward on those blocks: a
vocab-parallel loss, the partial gradients of the replicated leaves
summed over ``model`` after backward, the sync over the data axes, and
the ZeRO-1 update of each rank's (model, data) block.  The JAX package
writes none of that by hand: its step runs the sync in ``shard_map``
over the data axes and lets GSPMD do the rest.  ``group=`` (the
replicated cache of a plain process group) stays.
"""

from __future__ import annotations

import dataclasses
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import telemetry
from ..compat import axis_index, axis_size
from ..core.earlybird import (SyncConfig, SyncLog, model_axis_sum,
                              value_and_synced_grad)
from ..core.fabric_torch import resolve_device
from ..core.flash_decode import flash_decode_shard
from ..models import convert, lm
from ..models import tp as tpc
from ..optim.adamw import (AdamWConfig, adamw_update, init_opt_state,
                           init_zero1_state, opt_state_specs, zero1_update)
from ..optim.schedule import warmup_cosine
from . import mesh as _mesh
from .mesh import NamedSharding, PartitionSpec as P


@dataclass(frozen=True)
class StepConfig:
    sync_mode: str = "partitioned"     # bulk | per_leaf | partitioned
    aggr_bytes: int = 4 << 20
    comm_dtype: Optional[str] = None   # e.g. 'bfloat16' (grad compression)
    remat: bool = True
    param_dtype: str = "bfloat16"
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    adam: AdamWConfig = field(default_factory=AdamWConfig)
    cache_dtype: str = "bfloat16"
    ce_gather_targets: bool = False  # True = take the targets by a gather
    flash_decode: bool = False       # partitioned-KV decode attention
    seq_parallel: bool = True        # sequence-parallel residual stream
    moe_chunk: int = 0               # override MoE dispatch chunk (0=default)
    capacity_factor: float = 0.0     # override MoE capacity factor (0=default)


def _apply_overrides(cfg: lm.ModelConfig, scfg: StepConfig
                     ) -> lm.ModelConfig:
    """``cfg`` with the step's MoE overrides (``moe_chunk``,
    ``capacity_factor``) where they are set, as the JAX package's train
    and prefill steps apply them (its decode step does not)."""
    if cfg.moe is not None and (scfg.moe_chunk or scfg.capacity_factor):
        moe = cfg.moe
        if scfg.moe_chunk:
            moe = dataclasses.replace(moe, dispatch_chunk=scfg.moe_chunk)
        if scfg.capacity_factor:
            moe = dataclasses.replace(moe,
                                      capacity_factor=scfg.capacity_factor)
        cfg = cfg.replace(moe=moe)
    return cfg


def build_state(cfg: lm.ModelConfig, seed: int = 0, device="cuda",
                adam: AdamWConfig = AdamWConfig(), mesh=None
                ) -> Dict[str, Any]:
    """A fresh training state ``{"params", "opt"}``: the model of
    ``cfg`` with weights drawn from a generator on ``device`` seeded
    with ``seed``, requiring gradients, and zero AdamW moments.  On a
    ``mesh`` the model is ``cfg.with_tp(M)`` over its ``model`` axis of
    M ranks: the whole model is drawn and this rank keeps its blocks
    (``convert.tp_shard_model``; a block of Mamba's d_inner may cut a
    head), bit for bit those of the unsharded model; the moments are
    the ZeRO-1 DTensors of :func:`opt_specs`, each rank allocating its
    (model, data) block only.  A Mamba arch is refused where M does not
    divide a Mamba parameter's split dim, as in the train step."""
    dev = resolve_device(device)
    if mesh is not None:
        cfg = cfg.with_tp(_mesh.model_size(mesh))
        _require_mamba_placed("build_state", cfg, _mesh.model_size(mesh))
    model = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    if mesh is not None and _mesh.model_size(mesh) > 1:
        model = convert.tp_shard_model(model, cfg, mesh)
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    opt = init_opt_state(named, adam) if mesh is None else \
        init_zero1_state(named, adam, mesh, opt_specs(cfg, mesh)["m"],
                         shapes=lm.param_shapes(cfg))
    return {"params": model, "opt": opt}


def _require_member(what: str, mesh) -> None:
    if not _mesh.in_mesh(mesh):
        raise ValueError(f"{what}: this rank is not in the mesh {mesh}")


def _require_mamba_placed(what: str, cfg: lm.ModelConfig, m: int,
                          serving: bool = False) -> None:
    """Refuse a Mamba arch on ``m`` model ranks exactly where the JAX
    package's ``jax.device_put`` refuses its Mamba leaves: a dim split
    over ``model`` that ``m`` does not divide, among the
    ``layers.mamba.*`` parameter leaves of ``cfg`` (``cfg.with_tp(m)``:
    ``lm.param_specs``) and, when ``serving``, the cache's ``state``
    (split by heads) and ``conv_x`` (by channels; ``lm.cache_specs``)."""
    if cfg.mamba is None:
        return
    shapes, specs = lm.param_shapes(cfg), lm.param_specs(cfg)
    leaves = [(k, shapes[k], specs[k]) for k in shapes
              if k.startswith("layers.mamba.")]
    holder = ("the parameters (lm.param_specs) and their ZeRO-1 moments"
              " (optim.adamw.opt_state_specs)")
    if serving:
        cshapes, cspecs = lm.cache_shapes(cfg, 1, 1), lm.cache_specs(cfg)
        leaves += [(f"cache {k}", cshapes[k], cspecs[k])
                   for k in ("state", "conv_x")]
        holder = ("the parameters (lm.param_specs) and the cache's state"
                  " and conv_x tail (lm.cache_specs)")
    bad = [f"{k} dim {d} ({shape[d]})" for k, shape, spec in leaves
           for d, e in enumerate(tuple(spec))
           if lm.MODEL_AXIS in _mesh.spec_axes(e) and shape[d] % m]
    if bad:
        raise NotImplementedError(
            f"{what}: {cfg.name}'s Mamba leaves {', '.join(bad)} do not"
            f" split evenly over {m} model ranks; {holder} split them over"
            f" 'model' in equal blocks, which JAX's device_put refuses too")


class _ParamCheck:
    """Raise ``ValueError`` unless a model holds this rank's block of
    every leaf (``lm.param_blocks``: ``shapes`` by parameter name, as
    ``lm.local_shapes`` gives them); a model is checked once."""

    def __init__(self, what: str, shapes: Dict[str, Tuple[int, ...]]):
        self.what, self.shapes, self._checked = what, shapes, None

    def __call__(self, params: lm.LM) -> None:
        if self._checked is not None and self._checked() is params:
            return
        got = {k: tuple(p.shape) for k, p in params.named_parameters()}
        if set(got) != set(self.shapes):
            raise ValueError(f"{self.what}: the model's parameters are not"
                             f" the config's")
        for k, shape in self.shapes.items():
            if got[k] != shape:
                raise ValueError(
                    f"{self.what}: parameter {k} is {got[k]}, this rank's"
                    f" block on the mesh is {shape} (lm.param_blocks;"
                    f" models.convert.tp_shard_model makes the blocks)")
        self._checked = weakref.ref(params)


def param_shardings(cfg: lm.ModelConfig, mesh) -> Dict[str, Any]:
    """Each parameter leaf's sharding (``lm.param_specs`` of
    ``cfg.with_tp(M)`` on ``mesh``), in the JAX package's parameter tree
    (the layout of a checkpoint's ``params``); a dim split over
    ``model`` that does not divide takes ``launch.mesh.block``'s blocks
    (``runtime.elastic.reshard``)."""
    cfg = cfg.with_tp(_mesh.model_size(mesh))
    return convert.leaves_to_jax({k: NamedSharding(mesh, s)
                                  for k, s in lm.param_specs(cfg).items()})


def opt_specs(cfg: lm.ModelConfig, mesh) -> Dict[str, Any]:
    """The optimizer state's specs on ``mesh``: each parameter's spec of
    ``cfg.with_tp(M)`` plus ZeRO-1 over its data axes
    (``optim.adamw.opt_state_specs``)."""
    cfg = cfg.with_tp(_mesh.model_size(mesh))
    return opt_state_specs(lm.param_specs(cfg), lm.param_shapes(cfg),
                           dp_axes=_mesh.dp_axes(mesh),
                           dp_total=_mesh.dp_size(mesh))


def opt_shardings(cfg: lm.ModelConfig, mesh) -> Dict[str, Any]:
    """The optimizer state's shardings (:func:`opt_specs` on ``mesh``)
    in the JAX package's tree, the one ``ckpt.checkpoint.restore`` takes
    for a checkpoint's ``opt``."""
    specs = opt_specs(cfg, mesh)
    return {"step": NamedSharding(mesh, specs["step"]),
            **{k: convert.leaves_to_jax({n: NamedSharding(mesh, s)
                                         for n, s in specs[k].items()})
               for k in ("m", "v")}}


def batch_to_device(batch: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """A data-stream batch (NumPy) as tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def _check_batch(what: str, cfg: lm.ModelConfig, b: Dict[str, Any],
                 batch: int, seq_len: int, dev: torch.device, *,
                 labels: bool = False) -> None:
    """Raise ``ValueError`` unless every entry of ``b`` has its step's
    shape on ``dev``: ``tokens`` (batch, seq_len), or ``embeds`` (batch,
    seq_len, d) for the audio stub; ``labels`` as the tokens; where
    present, ``positions`` (3, batch, seq_len) under M-RoPE, else
    (batch, seq_len) or (seq_len,), and ``patch_embeds`` (batch, P, d)
    with P <= seq_len."""
    d = cfg.d_model
    rows = (batch, seq_len)

    def bad(name, t, need):
        got = "missing" if t is None else f"{tuple(t.shape)} on {t.device}"
        raise ValueError(f"{what}: {name} {got}, need {need} on {dev}")
    key = lm.input_key(cfg)
    want = {key: [(*rows, d) if key == "embeds" else rows]}
    if labels:
        want["labels"] = [rows]
    if "positions" in b:
        want["positions"] = ([(3, *rows)] if cfg.mrope_sections is not None
                             else [rows, (seq_len,)])
    for name, ok in want.items():
        t = b.get(name)
        if t is None or tuple(t.shape) not in ok \
                or t.device.type != dev.type:
            bad(name, t, " or ".join(map(str, ok)))
    pe = b.get("patch_embeds")
    if pe is not None and (pe.dim() != 3 or pe.shape[0] != batch
                           or pe.shape[1] > seq_len or pe.shape[2] != d
                           or pe.device.type != dev.type):
        bad("patch_embeds", pe, f"({batch}, P <= {seq_len}, {d})")


def make_train_step(cfg: lm.ModelConfig, scfg: StepConfig, *, seq_len: int,
                    batch: int, group=None, device="cuda",
                    mesh=None) -> Callable:
    """``step_fn(state, batch) -> (state, loss)``: one training step on
    this rank's ``batch`` rows of ``seq_len`` tokens; ``state`` =
    ``{"params": LM, "opt": ...}`` is updated in place and returned.
    ``group`` is the data-parallel process group (None: the default
    group, which must be initialised).  ``step_fn.log`` is the
    :class:`~repro_torch.core.earlybird.SyncLog` of the last step.

    With a ``mesh`` (``group`` then unused), ``batch`` is the global
    batch: each rank passes the rows of its index over the data axes
    (``batch / dp`` of them, as ``data.pipeline.for_model(...,
    host_index=mesh.axis_index(mesh, dp_axes(mesh)),
    host_count=dp_size(mesh))`` gives them), the sync runs over the data
    axes and the state's moments are ZeRO-1 over every axis
    (``build_state(..., mesh=mesh)``, :func:`opt_specs`).  The model is
    ``cfg.with_tp(M)`` over the ``model`` axis of M ranks, ``params``
    this rank's blocks of it (``lm.param_blocks``; ``build_state`` or
    ``models.convert.tp_shard_model`` make them), and the loss runs the
    tensor-, expert- and, with ``scfg.seq_parallel`` where M divides
    ``seq_len``, sequence-parallel forward and its backward
    (``models.tp``), the cross entropy vocab parallel, the MoE capacity
    counting this data rank's rows (as the JAX package's ``shard_map``
    over the data axes).  After backward the partial gradients of the
    replicated leaves (``lm.partial_grad_leaves``) are summed over
    ``model`` in buckets of ``scfg.aggr_bytes``
    (``earlybird.model_axis_sum``; ``step_fn.model_log`` logs them; none
    on one ``model`` rank, where every gradient is whole), the early-bird
    sync runs over the data axes on the local leaves, and
    ``zero1_update`` updates this rank's (model, data) block."""
    cfg = _apply_overrides(cfg.replace(param_dtype=scfg.param_dtype), scfg)
    dev = resolve_device(device)
    ospecs = tp = grad_sum = check = blocks = shapes = None
    if mesh is not None:
        _require_member("train_step", mesh)
        m = _mesh.model_size(mesh)
        cfg = cfg.with_tp(m)
        _require_mamba_placed("train_step", cfg, m)
        dp = _mesh.dp_size(mesh)
        if batch % dp:
            raise ValueError(f"train_step: a global batch of {batch} does"
                             f" not split over {dp} data-parallel ranks")
        batch //= dp
        group = _mesh.axis_group(mesh, _mesh.dp_axes(mesh))
        ospecs = opt_specs(cfg, mesh)["m"]
        tp = tpc.from_mesh(mesh, scfg.seq_parallel)
        blocks = lm.param_blocks(cfg, mesh)
        shapes = lm.param_shapes(cfg)
        check = _ParamCheck("train_step", lm.local_shapes(cfg, blocks))
        if m > 1:
            grad_sum = model_axis_sum(
                lm.partial_grad_leaves(cfg, tp.splits_seq(seq_len)),
                tp.group, scfg.aggr_bytes)
    sync = SyncConfig(mode=scfg.sync_mode, group=group,
                      aggr_bytes=scfg.aggr_bytes, comm_dtype=scfg.comm_dtype)

    def local_loss(model, b, param_hook):
        return lm.loss_fn(cfg, model, b, remat=scfg.remat,
                          param_hook=param_hook,
                          gather_targets=scfg.ce_gather_targets, tp=tp)

    vg = value_and_synced_grad(local_loss, sync, grad_sum)

    def step_fn(state: Dict[str, Any], b: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, Any], torch.Tensor]:
        _check_batch("train_step", cfg, b, batch, seq_len, dev,
                     labels=True)
        model = state["params"]
        if check is not None:
            check(model)
        with telemetry.span("repro.train_step"):
            loss, grads = vg(model, b)
            step_fn.log = vg.log
            if grad_sum is not None:
                step_fn.model_log = grad_sum.log
            with telemetry.span("repro.optim"):
                lr = warmup_cosine(state["opt"]["step"],
                                   peak_lr=scfg.peak_lr,
                                   warmup_steps=scfg.warmup_steps,
                                   total_steps=scfg.total_steps)
                named = dict(model.named_parameters())
                if mesh is None:
                    adamw_update(named, grads, state["opt"], lr, scfg.adam)
                else:
                    zero1_update(named, grads, state["opt"], lr, scfg.adam,
                                 mesh, ospecs, blocks=blocks, shapes=shapes)
        return state, loss

    step_fn.log = vg.log
    step_fn.model_log = SyncLog()
    return step_fn


def make_cache(cfg: lm.ModelConfig, scfg: StepConfig, *, batch: int,
               max_len: int, device="cuda", mesh=None
               ) -> Dict[str, torch.Tensor]:
    """A zeroed cache of ``max_len`` positions in the step's cache dtype;
    on a ``mesh``, DTensors placed by :func:`_cache_shardings`, each rank
    allocating its block only."""
    dt = getattr(torch, scfg.cache_dtype)
    if mesh is None:
        return lm.init_cache(cfg, batch, max_len, dt, device=device)
    dev = resolve_device(device)
    shapes = lm.cache_shapes(cfg, batch, max_len)
    return {k: _mesh.zeros(shapes[k], sh.spec, mesh, dt, dev)
            for k, sh in _cache_shardings(cfg, mesh, batch).items()}


def _cache_axes(mesh, batch: int) -> Tuple[Optional[tuple], tuple]:
    """The JAX package's cache rule: (batch axes, sequence axes) --
    batch over the data axes and sequence over ``model``, or, when the
    batch does not split over the data axes (``long_500k``'s batch 1),
    no batch axes and every axis to the sequence."""
    dp, n = _mesh.dp_axes(mesh), _mesh.dp_size(mesh)
    if batch >= n and batch % n == 0:
        return dp, ("model",)
    return None, _mesh.all_axes(mesh)


def _cache_shardings(cfg: lm.ModelConfig, mesh, batch: int
                     ) -> Dict[str, NamedSharding]:
    """Each cache entry's sharding under the JAX package's rule
    (:func:`_cache_axes`, ``lm.cache_specs``)."""
    b_ax, s_ax = _cache_axes(mesh, batch)
    return {k: NamedSharding(mesh, s) for k, s in
            lm.cache_specs(cfg, data_axis=b_ax, seq_axis=s_ax).items()}


# Cache entries with a sequence axis (axis 2 of the stacked layout); the
# Mamba state and convolution tails have none.
_SEQ_CACHES = ("k", "v", "ckv", "kr")


def _check_cache(cache, scfg: StepConfig, batch: int, need: int) -> None:
    for name, t in cache.items():
        if t.dtype != getattr(torch, scfg.cache_dtype) \
                or t.shape[1] != batch \
                or (name in _SEQ_CACHES and t.shape[2] < need):
            raise ValueError(
                f"cache {name} {t.dtype} {tuple(t.shape)} does not hold"
                f" batch {batch} and {need} positions in"
                f" {scfg.cache_dtype}")


def _seq_len(cache) -> int:
    """The positions a cache holds (0 for Mamba's, which holds none)."""
    return next((cache[k].shape[2] for k in _SEQ_CACHES if k in cache), 0)


class _CacheLayout:
    """Where a serving step on a mesh works: this rank's batch rows
    (None: all of them), its slice of the cache's sequence, the group
    over the sequence axes (the flash decode's, and the one a
    sequence-split cache is gathered over), the tensor-parallel context
    over ``model`` and this rank's parameter blocks."""

    def __init__(self, what: str, cfg: lm.ModelConfig, scfg: StepConfig,
                 mesh, batch: int):
        _require_member(what, mesh)
        _require_mamba_placed(what, cfg, _mesh.model_size(mesh),
                              serving=True)
        self.what, self.mesh, self.batch = what, mesh, batch
        self.b_ax, s_ax = _cache_axes(mesh, batch)
        self.n_seq = _mesh.size(mesh, s_ax)
        self.seq_index = _mesh.axis_index(mesh, s_ax)
        self.group = _mesh.axis_group(mesh, s_ax)
        self.rows = None
        if self.b_ax is not None:
            n = _mesh.dp_size(mesh)
            i = _mesh.axis_index(mesh, self.b_ax)
            self.rows = slice(i * (batch // n), (i + 1) * (batch // n))
        self.shardings = _cache_shardings(cfg, mesh, batch)
        self.tp = tpc.from_mesh(
            mesh, scfg.seq_parallel,
            self.b_ax if self.rows is not None
            and _mesh.dp_size(mesh) > 1 else None)
        self.check_params = _ParamCheck(
            what, lm.local_shapes(cfg, lm.param_blocks(cfg, mesh)))

    def seq_slice(self, cache_len: int) -> Tuple[int, Optional[int]]:
        """(positions a rank holds, the first of this rank's or None when
        the sequence is not split) of a cache of ``cache_len``."""
        if cache_len % self.n_seq:
            raise ValueError(f"{self.what}: a cache of {cache_len} positions"
                             f" does not split over {self.n_seq} ranks")
        s_local = cache_len // self.n_seq
        return s_local, (self.seq_index * s_local if self.n_seq > 1
                         else None)

    def local_cache(self, cache: Dict) -> Dict[str, torch.Tensor]:
        """Each entry's block on this rank; the entries must be DTensors
        placed by :func:`_cache_shardings`."""
        from torch.distributed.tensor import DTensor
        out = {}
        for k, sh in self.shardings.items():
            t = cache.get(k)
            if not isinstance(t, DTensor) or t.device_mesh != self.mesh \
                    or list(t.placements) != _mesh.to_placements(
                        sh.spec, self.mesh, t.dim()):
                raise ValueError(f"cache {k} is not a DTensor placed by"
                                 f" {sh}")
            out[k] = t.to_local()
        return out

    def local_rows(self, x: Optional[torch.Tensor], dim: int = 0):
        if x is None or self.rows is None:
            return x
        return x.narrow(dim, self.rows.start, self.rows.stop - self.rows.start)

    def local_batch(self, b: Dict[str, torch.Tensor]) -> Dict:
        """This rank's rows of a prefill batch (``_check_batch``'s
        shapes): the batch axis is dim 0, but dim 1 of M-RoPE
        ``positions`` (3, B, S); 1-D ``positions`` (S,) are shared."""
        def dim(k, t):
            return {3: 1, 2: 0}.get(t.dim()) if k == "positions" else 0
        return {k: t if dim(k, t) is None else self.local_rows(t, dim(k, t))
                for k, t in b.items()}

    @property
    def n_rows(self) -> int:
        return self.batch if self.rows is None else \
            self.rows.stop - self.rows.start

    def gather_rows(self, logits: torch.Tensor) -> torch.Tensor:
        """The (batch, V) logits on every rank from each rank's rows."""
        if self.rows is None or _mesh.dp_size(self.mesh) == 1:
            return logits
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(
            logits, self.mesh, _mesh.to_placements(P(self.b_ax), self.mesh, 2),
            run_check=False, shape=torch.Size((self.batch, logits.shape[1])),
            stride=(logits.shape[1], 1)).full_tensor()


def make_prefill_step(cfg: lm.ModelConfig, scfg: StepConfig, *,
                      seq_len: int, batch: int, device="cuda",
                      mesh=None) -> Callable:
    """``prefill_step(params, batch, cache) -> (logits (batch, V) f32,
    cache)``, the cache written in place.  ``batch`` is the JAX step's
    dict: ``tokens`` (batch, seq_len), or ``embeds`` (batch, seq_len, d)
    for the audio stub; optionally ``patch_embeds`` and ``positions``.
    A tensor is taken as the model input (:func:`lm.input_batch`).
    The MoE overrides of ``scfg`` apply (:func:`_apply_overrides`).

    On a ``mesh`` the model is ``cfg.with_tp(M)`` over its ``model``
    axis of M ranks, ``params`` this rank's blocks of it
    (``lm.param_blocks``) and the cache ``make_cache(..., mesh=mesh)``'s
    (placed by :func:`_cache_shardings`); every rank passes the whole
    batch, runs its batch rows tensor parallel (sequence parallel with
    ``scfg.seq_parallel`` where ``seq_len`` splits over M) and writes its
    block of the cache, and every rank gets all the logits."""
    cfg = _apply_overrides(cfg.replace(param_dtype=scfg.param_dtype), scfg)
    dev = resolve_device(device)
    lay = None
    if mesh is not None:
        cfg = cfg.with_tp(_mesh.model_size(mesh))
        lay = _CacheLayout("prefill_step", cfg, scfg, mesh, batch)

    def prefill_step(params: lm.LM, b, cache) -> Tuple[torch.Tensor, Dict]:
        if isinstance(b, torch.Tensor):
            b = lm.input_batch(cfg, b)
        _check_batch("prefill_step", cfg, b, batch, seq_len, dev)
        if lay is None:
            _check_cache(cache, scfg, batch, seq_len)
            return lm.prefill(cfg, params, b, cache=cache)
        lay.check_params(params)
        local = lay.local_cache(cache)
        s_local, offset = lay.seq_slice(_seq_len(cache))
        if _seq_len(cache) and s_local * lay.n_seq < seq_len:
            raise ValueError(f"prefill_step: a cache of {s_local * lay.n_seq}"
                             f" positions does not hold {seq_len}")
        _check_cache(local, scfg, lay.n_rows, s_local)
        logits, _ = lm.prefill(cfg, params, lay.local_batch(b), cache=local,
                               cache_offset=offset, cache_group=lay.group,
                               tp=lay.tp)
        return lay.gather_rows(logits), cache

    return prefill_step


def _flash_decode_fn(group, split: bool = True) -> Callable:
    """The partitioned-KV decode hook (``attention_fwd``'s
    ``decode_attn``): rank r of ``group``'s N takes the sequence slice
    [r S/N, (r+1) S/N) of the cache, and ``flash_decode_shard`` combines
    the partitions -- the paper's partition-consume pattern on the
    inference side.  With ``split`` every rank holds the whole cache and
    the hook takes its slice (a plain process group); without, the
    cache given is already this rank's slice (the mesh's
    sequence-sharded cache)."""
    def hook(q, k, v, *, pos, window, attn_softcap, scale):
        if split:
            n, r = axis_size(group), axis_index(group)
            s = k.shape[1]
            if s % n:
                raise ValueError(f"flash_decode: a cache of {s} positions"
                                 f" does not split over {n} ranks")
            sl = slice(r * (s // n), (r + 1) * (s // n))
            k, v = k[:, sl], v[:, sl]
        return flash_decode_shard(q, k, v, group=group, pos=pos,
                                  window=window, attn_softcap=attn_softcap,
                                  scale=scale)
    return hook


def make_decode_step(cfg: lm.ModelConfig, scfg: StepConfig, *,
                     seq_len: int, batch: int, device="cuda",
                     group=None, mesh=None) -> Callable:
    """``decode_step(params, cache, tokens (batch,), pos, embeds=None)
    -> (logits (batch, V) f32, cache)``; ``seq_len`` is the cache
    length, one new token is decoded at write offset ``pos``.  The
    audio stub decodes from ``embeds`` (batch, 1, d) instead of
    tokens.  With ``scfg.flash_decode`` the attention layers decode
    through the partitioned-KV flash decode over the process group
    ``group`` (None: the default group, which must be initialised; every
    rank calls the step with the same inputs); ``seq_len`` must split
    evenly over its ranks.  As the JAX package's decode step, this one
    takes no MoE overrides.

    On a ``mesh`` (``group`` then unused) the model and the cache are
    as :func:`make_prefill_step` takes them: each rank decodes its batch
    rows tensor parallel, writes the new K/V (or MLA latent) only where
    ``pos`` falls in its sequence slice, and with ``flash_decode``
    attends to that slice alone with q's heads gathered over ``model``,
    the partitions combined over the sequence axes; without, each
    attention layer first gathers the whole cache over them."""
    cfg = cfg.replace(param_dtype=scfg.param_dtype)
    dev = resolve_device(device)
    key = lm.input_key(cfg)
    decode_attn, lay = None, None
    if mesh is not None:
        cfg = cfg.with_tp(_mesh.model_size(mesh))
        lay = _CacheLayout("decode_step", cfg, scfg, mesh, batch)
        s_local, offset = lay.seq_slice(seq_len)
        if scfg.flash_decode:
            decode_attn = _flash_decode_fn(lay.group, split=False)
    elif scfg.flash_decode:
        n = axis_size(group)
        if seq_len % n:
            raise ValueError(f"flash_decode: a cache of {seq_len} positions"
                             f" does not split over {n} ranks")
        decode_attn = _flash_decode_fn(group)

    def decode_step(params: lm.LM, cache, tokens: Optional[torch.Tensor],
                    pos: int, embeds: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict]:
        x, need = ((embeds, (batch, 1, cfg.d_model)) if key == "embeds"
                   else (tokens, (batch,)))
        if x is None or tuple(x.shape) != need or x.device.type != dev.type:
            got = "missing" if x is None else \
                f"{tuple(x.shape)} on {x.device}"
            raise ValueError(f"decode_step: {key} {got}, need {need} on"
                             f" {dev}")
        if not 0 <= pos < seq_len:
            raise ValueError(f"decode_step: position {pos} outside the"
                             f" cache of {seq_len}")
        if lay is None:
            _check_cache(cache, scfg, batch, seq_len)
            return lm.decode_step(cfg, params, cache, tokens, pos,
                                  embeds=embeds, decode_attn=decode_attn)
        lay.check_params(params)
        local = lay.local_cache(cache)
        tokens, embeds = lay.local_rows(tokens), lay.local_rows(embeds)
        _check_cache(local, scfg, lay.n_rows, s_local)
        logits, _ = lm.decode_step(cfg, params, local, tokens, pos,
                                   embeds=embeds, decode_attn=decode_attn,
                                   cache_offset=offset,
                                   cache_group=lay.group, tp=lay.tp)
        return lay.gather_rows(logits), cache

    return decode_step
