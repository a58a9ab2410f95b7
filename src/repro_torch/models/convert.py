"""Weights, caches, gradients and optimizer state across the two layouts.

The JAX package keeps parameters as a nested dict whose per-layer
entries are stacked on a leading L axis; the port keeps one module per
layer with the same names and shapes.  Carry-over is therefore a copy:
``tree["layers"]["attn"]["wq"][i]`` becomes ``layers.{i}.attn.wq``, and
a stacked expert leaf ``tree["layers"]["moe"]["w_gate"]`` (L, E, D, F)
becomes ``layers.{i}.moe.w_gate`` (E, D, F).
The functions take and give NumPy arrays (``jax.tree.map(np.asarray,
params)``), so this module imports nothing of JAX.  The training state
is ``{"params": LM, "opt": {"step", "m", "v"}}`` with the moments keyed
by parameter name, or under ZeRO-1 (``optim.adamw.init_zero1_state``)
by leaf name as DTensors of the stacked leaves; in the JAX layout it is
``{"params": tree, "opt": {"step", "m": tree, "v": tree}}``, the tree
the checkpoints hold.

A tensor-parallel rank holds its block of every leaf
(``lm.param_blocks``): :func:`tp_params_from_jax` slices the JAX
package's parameters to it, :func:`tp_shard_model` a whole port model.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from ..core.fabric_torch import resolve_device
from . import lm
from .lm import LM, ModelConfig, param_leaves


def _flatten(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, object]]:
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def _state_dict(tree: Dict, n_layers: int) -> Dict[str, np.ndarray]:
    """Port parameter names -> arrays, the stacked layer axis split."""
    out = {}
    for name, arr in _flatten(tree):
        if name.startswith("layers."):
            rest = name[len("layers."):]
            for i in range(n_layers):
                out[f"layers.{i}.{rest}"] = np.asarray(arr)[i]
        else:
            out[name] = np.asarray(arr)
    return out


@torch.no_grad()
def params_from_jax(tree: Dict, cfg: ModelConfig, device="cuda",
                    dtype=None) -> LM:
    """An :class:`LM` holding the JAX package's parameters ``tree``
    (NumPy leaves), in ``dtype`` (default: the config's) on ``device``.
    Raises if a name or shape differs."""
    model = LM(cfg, device=resolve_device(device), dtype=dtype)
    arrays = _state_dict(tree, cfg.n_layers)
    params = dict(model.named_parameters())
    if set(arrays) != set(params):
        raise ValueError(
            f"parameter names differ: only in JAX"
            f" {sorted(set(arrays) - set(params))}, only in the port"
            f" {sorted(set(params) - set(arrays))}")
    for name, p in params.items():
        a = arrays[name]
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX shape {a.shape}, port shape"
                             f" {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))
    return model


def _check_leaves(have: Mapping[str, Tuple[int, ...]], cfg: ModelConfig
                  ) -> None:
    want = lm.param_shapes(cfg)
    if set(have) != set(want):
        raise ValueError(f"parameter leaves differ: only given"
                         f" {sorted(set(have) - set(want))}, only in the"
                         f" model {sorted(set(want) - set(have))}")
    for name, shape in want.items():
        if tuple(have[name]) != tuple(shape):
            raise ValueError(f"{name}: given shape {tuple(have[name])},"
                             f" the model's {tuple(shape)}")


@torch.no_grad()
def tp_params_from_jax(tree: Dict, cfg: ModelConfig, mesh, device="cuda",
                       dtype=None) -> LM:
    """This rank's tensor-parallel model on ``mesh``: the JAX package's
    parameters ``tree`` at ``cfg`` (already ``cfg.with_tp(M)``; NumPy
    leaves) sliced to this rank's block of every leaf
    (``lm.param_blocks``: the blocks of ``lm.param_specs``), in
    ``dtype`` (default: the config's) on ``device``.  The replicated
    leaves (``wk``, ``wv``, the MLA latent projections, ``w_B``, ``w_C``,
    ``w_dt``, ``A_log``, ``D``, ``dt_bias``, the router and the norms)
    stay whole.  Raises if a leaf's name or shape differs."""
    leaves = {k: np.asarray(v) for k, v in jax_to_leaves(tree).items()}
    _check_leaves({k: v.shape for k, v in leaves.items()}, cfg)
    blocks = lm.param_blocks(cfg, mesh)
    model = lm.local_model(cfg, blocks, device=resolve_device(device),
                           dtype=dtype)
    for name, segs in param_leaves(model.named_parameters()):
        a = leaves[name][blocks[name]]
        for i, p in enumerate(segs):
            part = a[i] if name.startswith("layers.") else a
            p.copy_(torch.from_numpy(np.array(part, dtype=np.float32)))
    return model


@torch.no_grad()
def tp_shard_model(model: LM, cfg: ModelConfig, mesh) -> LM:
    """This rank's tensor-parallel model on ``mesh`` from a whole port
    model of ``cfg`` (a seeded ``serve.build_model``, so no JAX is
    needed): copies of its blocks of every leaf (``lm.param_blocks``) on
    the model's device, each in its parameter's dtype."""
    full = dict(model.named_parameters())
    _check_leaves({k: ((len(v), *v[0].shape) if k.startswith("layers.")
                       else tuple(v[0].shape))
                   for k, v in param_leaves(full.items())}, cfg)
    blocks = lm.param_blocks(cfg, mesh)
    local = lm.local_model(cfg, blocks, device=model.embed.device,
                           dtype=model.embed.dtype)
    for name, p in local.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            sl = blocks[".".join(["layers", *parts[2:]])][1:]
        else:
            sl = blocks[name]
        p.copy_(full[name][sl])
    return local


def cache_from_jax(cache: Dict, device="cuda", dtype=None
                   ) -> Dict[str, torch.Tensor]:
    """The JAX package's stacked decode cache (NumPy arrays with a
    leading L axis: attention {'k', 'v'}, MLA {'ckv', 'kr'}, Mamba
    {'state', 'conv_x', 'conv_B', 'conv_C'}) as the port's cache, in
    ``dtype`` (default f32)."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(arr, dtype=np.float32))
            .to(device=dev, dtype=dtype or torch.float32)
            for name, arr in cache.items()}


def cache_to_numpy(cache: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's cache as f32 NumPy arrays, in the JAX layout."""
    return {name: t.detach().float().cpu().numpy()
            for name, t in cache.items()}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy; bf16 (which NumPy lacks) widens exactly to f32."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy().copy()


def leaves_to_jax(leaves: Mapping[str, Any]) -> Dict[str, Any]:
    """Values by the port's leaf name (``embed``, ``layers.attn.wq``:
    :func:`~repro_torch.models.lm.param_leaves`' names, whose layers are
    already stacked) -> the JAX package's nested tree, leaf for leaf:
    ``layers.attn.wq`` lands at ``tree["layers"]["attn"]["wq"]``.  Takes
    anything as the values: the spec trees of ``lm.param_specs``,
    ``lm.param_shapes`` and ``optim.adamw.opt_state_specs``, or arrays."""
    tree: Dict[str, Any] = {}
    for name, val in leaves.items():
        parts = name.split(".")
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = val
    return tree


def named_to_jax(named: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Port tensors by parameter name (parameters, gradients or moments)
    -> the JAX package's nested tree of NumPy arrays, the layers stacked
    on a leading L axis."""
    return leaves_to_jax({
        name: np.stack([_to_numpy(t) for t in segs])
        if name.startswith("layers.") else _to_numpy(segs[0])
        for name, segs in param_leaves(named.items())})


def _is_sharded(moments: Mapping[str, Any]) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for t in moments.values())


def jax_to_leaves(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`leaves_to_jax`: a nested tree -> values by
    dotted leaf name."""
    return dict(_flatten(tree))


def moments_to_jax(moments: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """AdamW moments as a JAX tree of NumPy arrays: by parameter name
    (stacked here), or ZeRO-1 DTensors by leaf name (gathered whole: a
    collective over their mesh, every rank of it calls)."""
    if _is_sharded(moments):
        return leaves_to_jax({k: _to_numpy(t.full_tensor())
                              for k, t in moments.items()})
    return named_to_jax(moments)


def _moment_mesh(moments: Mapping[str, Any]):
    """The mesh of ZeRO-1 moments (DTensors), or None."""
    from torch.distributed.tensor import DTensor
    t = next(iter(moments.values()))
    return t.device_mesh if isinstance(t, DTensor) else None


def tp_named_to_jax(named: Mapping[str, torch.Tensor], cfg: ModelConfig,
                    mesh) -> Dict[str, Any]:
    """Whole leaves, as the JAX package's tree of NumPy arrays, from
    every rank's blocks (``lm.param_blocks``) of the parameters, their
    gradients or anything shaped so, by parameter name, on ``mesh``:
    the padded heads, experts and vocabulary, the ``torch.chunk`` blocks
    of the FFN and the equal blocks of Mamba's d_inner (which may cut a
    head), each leaf gathered over the axes it splits
    (``launch.mesh.gather_blocks``).  A collective call: every
    rank of the mesh makes it."""
    from ..launch.mesh import gather_blocks
    shapes, specs = lm.param_shapes(cfg), lm.param_specs(cfg)
    out = {}
    for name, segs in param_leaves(named.items()):
        local = torch.stack([t.detach() for t in segs]) \
            if name.startswith("layers.") else segs[0].detach()
        out[name] = _to_numpy(gather_blocks(local, shapes[name],
                                            specs[name], mesh))
    return leaves_to_jax(out)


def state_to_jax(state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's training state as the JAX package's state tree.  On a
    mesh (ZeRO-1 moments) each leaf is assembled from the ranks' blocks
    (:func:`tp_named_to_jax`, the moments' ``full_tensor()``): a
    collective call, every rank of the mesh makes it."""
    opt, model = state["opt"], state["params"]
    mesh = _moment_mesh(opt["m"])
    if mesh is not None:
        params = tp_named_to_jax(dict(model.named_parameters()),
                                 model.cfg, mesh)
    else:
        params = named_to_jax(dict(model.named_parameters()))
    return {"params": params,
            "opt": {"step": np.asarray(int(opt["step"]), np.int32),
                    "m": moments_to_jax(opt["m"]),
                    "v": moments_to_jax(opt["v"])}}


def _host(x) -> np.ndarray:
    """A restored leaf as a host array (a DTensor's whole value)."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        return _to_numpy(x)
    return np.asarray(x)


@torch.no_grad()
def opt_state_from_jax(opt: Dict, model: LM,
                       shapes: Mapping[str, Tuple[int, ...]] = None
                       ) -> Dict[str, Any]:
    """The JAX package's AdamW state ``{"step", "m", "v"}`` (NumPy
    trees) as the port's, the moments in f32 on ``model``'s device.
    Moments restored as DTensors (``ckpt.checkpoint.restore`` with
    shardings: ZeRO-1) stay so, keyed by leaf name, and must have the
    whole leaves' ``shapes`` (default: ``model``'s, when it holds whole
    leaves)."""
    params = dict(model.named_parameters())
    dev = model.embed.device
    out: Dict[str, Any] = {"step": torch.tensor(int(_host(opt["step"])),
                                                dtype=torch.int32,
                                                device=dev)}
    leaves = dict(param_leaves(params.items()))
    if shapes is None:
        shapes = {name: ((len(segs), *segs[0].shape) if name.startswith(
            "layers.") else tuple(segs[0].shape))
            for name, segs in leaves.items()}
    for key in ("m", "v"):
        flat = jax_to_leaves(opt[key])
        if _is_sharded(flat):
            if set(flat) != set(leaves):
                raise ValueError(f"opt {key}: leaves differ from the"
                                 f" model's")
            for name in leaves:
                want = tuple(shapes[name])
                if tuple(flat[name].shape) != want:
                    raise ValueError(f"opt {key} {name}: shape"
                                     f" {tuple(flat[name].shape)}, the"
                                     f" model's {want}")
            out[key] = {k: flat[k].to(torch.float32) for k in leaves}
            continue
        arrays = _state_dict({k: _host(v) for k, v in flat.items()},
                             model.cfg.n_layers)
        if set(arrays) != set(params):
            raise ValueError(f"opt {key}: names differ from the model's")
        out[key] = {}
        for name, p in params.items():
            a = np.asarray(arrays[name])
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"opt {key} {name}: JAX shape {a.shape},"
                                 f" port shape {tuple(p.shape)}")
            out[key][name] = torch.from_numpy(
                np.array(a, dtype=np.float32)).to(dev)
    return out


def state_from_jax(tree: Dict, cfg: ModelConfig, device="cuda",
                   dtype=None, mesh=None) -> Dict[str, Any]:
    """The JAX package's state tree (NumPy) as the port's training
    state, the parameters in ``dtype`` (default: the config's) and
    requiring gradients.  On a ``mesh`` the model is ``cfg.with_tp(M)``
    over its ``model`` axis and this rank keeps its block of every leaf
    (``lm.param_blocks``): the leaves must be the DTensors that
    ``ckpt.checkpoint.restore`` placed by ``launch.steps.param_shardings``
    (their local blocks are taken) and the moments the ZeRO-1 DTensors it
    placed by ``launch.steps.opt_shardings``."""
    if mesh is None:
        params = {k: _host(v)
                  for k, v in jax_to_leaves(tree["params"]).items()}
        model = params_from_jax(leaves_to_jax(params), cfg, device=device,
                                dtype=dtype)
        model.requires_grad_(True)
        return {"params": model,
                "opt": opt_state_from_jax(tree["opt"], model)}
    from torch.distributed.tensor import DTensor
    from ..launch.mesh import model_size
    cfg = cfg.with_tp(model_size(mesh))
    shapes, blocks = lm.param_shapes(cfg), lm.param_blocks(cfg, mesh)
    flat = jax_to_leaves(tree["params"])
    _check_leaves({k: tuple(v.shape) for k, v in flat.items()}, cfg)
    model = lm.local_model(cfg, blocks, device=resolve_device(device),
                           dtype=dtype)
    if not _is_sharded(jax_to_leaves(tree["opt"]["m"])):
        raise ValueError("state_from_jax on a mesh: restore the moments"
                         " with launch.steps.opt_shardings")
    with torch.no_grad():
        for name, segs in param_leaves(model.named_parameters()):
            want = tuple(s.stop - s.start for s in blocks[name])
            a = flat[name].to_local() if isinstance(flat[name], DTensor) \
                else None
            if a is None or tuple(a.shape) != want:
                raise ValueError(f"{name}: restored as {type(flat[name])}"
                                 f" {tuple(flat[name].shape)}, this rank's"
                                 f" block is {want} (param_shardings)")
            for i, p in enumerate(segs):
                p.copy_(a[i] if name.startswith("layers.") else a)
    model.requires_grad_(True)
    return {"params": model,
            "opt": opt_state_from_jax(tree["opt"], model, shapes)}
