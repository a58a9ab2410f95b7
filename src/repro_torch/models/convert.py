"""Weights and caches carried across from the JAX package.

The JAX package keeps parameters as a nested dict whose per-layer
entries are stacked on a leading L axis; the port keeps one module per
layer with the same names and shapes.  Carry-over is therefore a copy:
``tree["layers"]["attn"]["wq"][i]`` becomes ``layers.{i}.attn.wq``.
The functions take NumPy arrays (``jax.tree.map(np.asarray, params)``),
so this module imports nothing of JAX.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..core.fabric_torch import resolve_device
from .lm import LM, ModelConfig


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


def cache_from_jax(cache: Dict, device="cuda", dtype=None
                   ) -> Dict[str, torch.Tensor]:
    """The JAX package's stacked attention cache {'k', 'v'} (NumPy
    arrays, (L, B, S_max, n_kv, head_dim)) as the port's cache."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(cache[name], dtype=np.float32))
            .to(device=dev, dtype=dtype or torch.float32)
            for name in ("k", "v")}


def cache_to_numpy(cache: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's cache as f32 NumPy arrays, in the JAX layout."""
    return {name: t.detach().float().cpu().numpy()
            for name, t in cache.items()}
