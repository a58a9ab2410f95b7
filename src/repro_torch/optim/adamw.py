"""AdamW, as the JAX package writes it.

The port's counterpart of the JAX package's ``optim/adamw.py``.  The
update is the reference's formula, not ``torch.optim.AdamW`` (whose
decay and epsilon sit elsewhere): the gradient is scaled by the global
clip factor, ``u = (m / c1) / (sqrt(v / c2) + eps)`` and ``p <- p - lr *
(u + wd * p)``, in f32.  Parameters, moments and the step counter are
updated in place (the JAX package returns new arrays), which keeps one
copy of each on the card.

ZeRO-1, as the JAX package shards it: :func:`zero1_spec` adds the
data-parallel axes to a parameter's spec on its first free dim that the
data-parallel degree divides, and :func:`opt_state_specs` gives the
moments' specs for every leaf of the JAX parameter tree (by the port's
leaf name, the layers stacked).  On a mesh, :func:`init_zero1_state`
keeps each moment as a DTensor of which a rank holds only its block,
and :func:`zero1_update` updates that block of the (synchronized)
parameter block the rank holds with the same f32 operations in the same
order as :func:`adamw_update`, then all-gathers the updated blocks over
the data axes: the result is bit for bit the unsharded update's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Sequence, Tuple

import torch

from .. import compat
from ..launch import mesh as _mesh
from ..launch.mesh import PartitionSpec as P


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


def init_opt_state(params: Mapping[str, torch.Tensor], cfg: AdamWConfig
                   ) -> Dict[str, Any]:
    """Zero moments shaped like ``params`` (name -> tensor) and a 0-d
    int32 step counter, on the parameters' device."""
    dt = getattr(torch, cfg.moment_dtype)
    dev = next(iter(params.values())).device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
              for k, p in params.items()},
    }


def zero1_spec(param_spec: Sequence, shape: Sequence[int],
               dp_axes: Tuple[str, ...], dp_total: int) -> P:
    """Moment spec: the param spec + DP sharding on the first free dim
    divisible by the DP degree."""
    entries = list(param_spec) + [None] * (len(shape) - len(param_spec))
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dp_total > 0 and dim % dp_total == 0 and dim > 0:
            entries[i] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
            break
    return P(*entries)


def opt_state_specs(param_specs: Mapping[str, Sequence],
                    param_shapes: Mapping[str, Sequence[int]],
                    dp_axes: Tuple[str, ...] = ("data",),
                    dp_total: int = 1) -> Dict[str, Any]:
    """Sharding specs for the optimizer state (ZeRO-1), the moments by
    leaf name as ``lm.param_specs`` / ``lm.param_shapes`` give them."""
    m_specs = {k: zero1_spec(s, param_shapes[k], dp_axes, dp_total)
               for k, s in param_specs.items()}
    return {"step": P(), "m": m_specs, "v": dict(m_specs)}


def init_zero1_state(params: Mapping[str, torch.Tensor], cfg: AdamWConfig,
                     mesh, specs: Mapping[str, Sequence],
                     shapes: Mapping[str, Sequence[int]]
                     ) -> Dict[str, Any]:
    """Zero moments for ZeRO-1 on ``mesh``: per leaf of the JAX
    parameter tree (``specs``: ``opt_state_specs(...)["m"]``, by leaf
    name) a DTensor of the stacked leaf's whole shape (``shapes``:
    ``lm.param_shapes``), of which this rank allocates only its block --
    the data slice of its ``model`` block, the blocks of a split dim
    that does not divide taken by ``launch.mesh.block``'s rule, as
    ``lm.param_blocks``'; the step counter as in
    :func:`init_opt_state`."""
    dt = getattr(torch, cfg.moment_dtype)
    dev = next(iter(params.values())).device
    if set(shapes) != set(specs):
        raise ValueError(f"init_zero1_state: spec leaves {sorted(specs)}"
                         f" differ from the parameters' {sorted(shapes)}")
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        **{key: {k: _mesh.zeros(shapes[k], specs[k], mesh, dt, dev,
                                uneven=True)
                 for k in shapes} for key in ("m", "v")},
    }


def global_norm(tree: Mapping[str, torch.Tensor], sharded=(),
                group=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in f32.

    Tensor parallel: ``tree`` holds this rank's blocks, ``sharded`` the
    names of those that are blocks of a leaf split over ``group`` (the
    ``model`` axis); their sums of squares are summed over the group,
    each replicated leaf (whole on every rank) counted once.  The leaves
    are added in ``tree``'s order either way, so a group of one rank
    gives the unsharded norm's bits."""
    sums = torch.stack([x.float().square().sum() for x in tree.values()])
    if group is not None and compat.axis_size(group) > 1:
        split = torch.tensor([k in sharded for k in tree],
                             device=sums.device)
        part = compat.psum_(torch.where(split, sums, 0.0), group)
        sums = torch.where(split, part, sums)
    return sums.sum().sqrt()


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: Dict[str, Any],
                 lr, cfg: AdamWConfig) -> Tuple[Mapping, Dict[str, Any]]:
    """One AdamW step, in place.  ``grads`` must already be synchronized
    (equal on every rank); returns ``(params, state)``."""
    coef = _step_coefficients(grads, state, lr, cfg)
    for k, p in params.items():
        _update_block(p, grads[k], state["m"][k], state["v"][k], coef, cfg)
    return params, state


def _step_coefficients(grads: Mapping[str, torch.Tensor],
                       state: Dict[str, Any], lr, cfg: AdamWConfig,
                       sharded=(), group=None):
    """Advance the step counter; the clip factor (from the full
    gradients: :func:`global_norm`, over ``group`` for the ``sharded``
    blocks), the bias corrections and the learning rate as f32 scalars
    on the device."""
    state["step"] += 1
    step = state["step"].to(torch.float32)
    if cfg.clip_norm > 0:
        gnorm = global_norm(grads, sharded, group)
        scale = torch.clamp(cfg.clip_norm / gnorm.clamp_min(1e-12), max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=step.device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=step.device)
    c1 = 1.0 - f32(cfg.b1) ** step
    c2 = 1.0 - f32(cfg.b2) ** step
    return scale, c1, c2, f32(lr)


def _update_block(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                  v: torch.Tensor, coef, cfg: AdamWConfig) -> None:
    """The elementwise update of one block, in place: every f32
    operation in one order, whatever the block, so a block of a
    parameter gets the bits of the whole parameter's update."""
    scale, c1, c2, lr = coef
    gf = g.float() * scale
    m_new = cfg.b1 * m.float() + (1.0 - cfg.b1) * gf
    v_new = cfg.b2 * v.float() + (1.0 - cfg.b2) * gf.square()
    u = (m_new / c1) / ((v_new / c2).sqrt() + cfg.eps)
    pf = p.float()
    p.copy_(pf - lr * (u + cfg.weight_decay * pf))
    m.copy_(m_new)
    v.copy_(v_new)


@torch.no_grad()
def zero1_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: Dict[str, Any],
                 lr, cfg: AdamWConfig, mesh, specs: Mapping[str, Sequence],
                 blocks: Mapping[str, Tuple[slice, ...]],
                 shapes: Mapping[str, Sequence[int]]
                 ) -> Tuple[Mapping, Dict[str, Any]]:
    """One ZeRO-1 AdamW step on ``mesh``, in place: ``params`` by port
    name, ``grads`` synchronized, ``state`` from
    :func:`init_zero1_state` with its moment ``specs``.  Each rank
    holds the ``blocks`` of the whole leaves (``lm.param_blocks``,
    global offsets; on one ``model`` rank the whole leaves; a block of
    Mamba's d_inner may cut a head), ``shapes`` the whole leaves'
    (``lm.param_shapes``), its gradients whole for a replicated leaf
    and its block's for a split one.  Per leaf of the
    JAX tree this rank updates its (model, data) block of the stacked
    parameter and of the moments -- the data slice inside the model
    block it holds -- (:func:`_update_block`), and the updated slices
    are all-gathered over the data axes alone into its block
    (``compat.all_gather_``, one a leaf whose moment splits over them).
    The clip factor comes from the full gradients, the split leaves'
    squares summed over ``model`` (:func:`global_norm`), as in
    :func:`adamw_update`, whose result a mesh of one ``model`` rank
    equals bit for bit."""
    from ..models.lm import param_leaves
    leaves = param_leaves(params.items())
    model_group = None
    sharded = ()
    if _mesh.model_size(mesh) > 1:
        model_group = _mesh.axis_group(mesh, "model")
        split = {leaf for leaf, spec in specs.items()
                 if any("model" in _mesh.spec_axes(e) for e in spec)}
        sharded = {k for k in params
                   if _leaf_name(k) in split}
    coef = _step_coefficients(grads, state, lr, cfg, sharded, model_group)
    names = {id(t): k for k, t in params.items()}
    dp = _mesh.dp_axes(mesh)
    dp_group = _mesh.axis_group(mesh, dp)
    for leaf, segs in leaves:
        stacked = leaf.startswith("layers.")
        shape = tuple(shapes[leaf])
        mine = _mesh.local_slices(shape, specs[leaf], mesh, uneven=True)
        sl = tuple(slice(m.start - h.start, m.stop - h.start)
                   for m, h in zip(mine, blocks[leaf]))
        gsegs = [grads[names[id(t)]] for t in segs]

        def block(ts):
            if stacked:
                return torch.stack([t[sl[1:]] for t in ts[sl[0]]])
            return ts[0][sl]
        p_blk, g_blk = block(segs), block(gsegs)
        _update_block(p_blk, g_blk, state["m"][leaf].to_local(),
                      state["v"][leaf].to_local(), coef, cfg)
        d = next((i for i, e in enumerate(tuple(specs[leaf]))
                  if e is not None and set(_mesh.spec_axes(e)) & set(dp)),
                 None)
        if d is None and not stacked:  # updated in place, a view
            continue
        full = p_blk if d is None else \
            compat.all_gather_(p_blk.contiguous(), d, dp_group)
        if stacked:
            for t, f in zip(segs, full.unbind(0)):
                t.copy_(f)
        else:
            segs[0].copy_(full)
    return params, state


def _leaf_name(param_name: str) -> str:
    """The JAX tree's leaf name of a port parameter name (the layer
    index dropped)."""
    parts = param_name.split(".")
    if parts[0] == "layers" and len(parts) > 2 and parts[1].isdigit():
        return ".".join(["layers", *parts[2:]])
    return param_name
