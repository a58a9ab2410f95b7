"""The system under test: the port's model, steps and counters, built
from a configuration file and the benchmark's own weights.

This module is the only one of the harness that imports the port
(``repro_torch``); the plain references never import it.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Tuple

import torch

from . import weights
from .families import family
from .sizes import Sizes


def model_config(s: Sizes, param_dtype: str):
    """The port's ``ModelConfig`` of sizes ``s``, as its family gives it."""
    return family(s.family).port_config(s, param_dtype)


def port_params(model) -> Dict[str, object]:
    """Each leaf's parameters in the port's model: a per-layer parameter
    ``layers.<i>.<rest>`` under ``layers.<rest>``, by layer index ``i``;
    a parameter outside the layers under its own name."""
    out: Dict[str, object] = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            out.setdefault(".".join(["layers", *parts[2:]]), {})[
                int(parts[1])] = p
        else:
            out[name] = p
    return out


def placed(lf: weights.Leaf, w: torch.Tensor, params: Dict[str, object],
           n_layers: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(the port's parameter, its part of ``w``) of leaf ``lf`` drawn as
    ``w``: each row of a per-layer leaf in the port's layer of that
    index.  Raises when the port holds the leaf in other layers."""
    got = params[lf.name]
    if not lf.per_layer:
        return [(got, w)]
    ids = lf.layer_ids(n_layers)
    if sorted(got) != list(ids):
        raise ValueError(f"leaf {lf.name} covers layers {list(ids)}; the"
                         f" port holds it in layers {sorted(got)}")
    return [(got[i], w[j]) for j, i in enumerate(ids)]


@torch.no_grad()
def build_model(s: Sizes, seed: int, device, dtype: torch.dtype):
    """The port's model (``repro_torch.models.lm.LM``) of sizes ``s``
    holding the weights of seed ``seed``, drawn leaf by leaf on
    ``device`` (:mod:`weights`)."""
    from repro_torch.models.lm import LM
    cfg = model_config(s, str(dtype).split(".")[-1])
    model = LM(cfg, device=device)
    load(model, s, weights.leaves(s), seed, device, dtype)
    return cfg, model


@torch.no_grad()
def load(model, s: Sizes, specs: List[weights.Leaf], seed: int, device,
         dtype: torch.dtype) -> None:
    """Copy the leaves ``specs`` of seed ``seed`` into the port's
    ``model``, each where :func:`placed` puts it."""
    params = port_params(model)
    if set(params) != {lf.name for lf in specs}:
        raise ValueError(f"the port's leaves {sorted(params)} are not the"
                         f" benchmark's {sorted(lf.name for lf in specs)}")
    for lf in specs:
        w = weights.draw(lf, seed, device, dtype)
        for p, part in placed(lf, w, params, s.n_layers):
            p.copy_(part)
        del w


class Group:
    """The one-rank process group the port's train step syncs over,
    started through a ``FileStore`` in a temporary directory (``nccl``
    on the card, ``gloo`` on the CPU); :meth:`close` ends it."""

    def __init__(self, device: torch.device):
        import torch.distributed as dist
        self._tmp = tempfile.TemporaryDirectory(prefix="perfbench-pg-")
        store = dist.FileStore(os.path.join(self._tmp.name, "store"), 1)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=store, rank=0, world_size=1)

    def close(self) -> None:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
        self._tmp.cleanup()


def build_kernels(s: Sizes, kind: str) -> None:
    """Build (first run in a checkout) or find the port's kernels that a
    ``kind`` (``"train"``, ``"prefill"``) run of ``s`` builds ahead."""
    names = family(s.family).kernels_ahead(s, kind)
    if names:
        from repro_torch.kernels import build
        build.build(tuple(names))
