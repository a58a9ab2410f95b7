"""The system under test: the port's model, steps and counters, built
from a configuration file and the benchmark's own weights.

This module is the only one of the harness that imports the port
(``repro_torch``); the plain references never import it.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict

import torch

from . import weights
from .sizes import Sizes


def model_config(s: Sizes, param_dtype: str):
    """The port's ``ModelConfig`` of sizes ``s``."""
    from repro_torch.models.lm import ModelConfig
    if s.family == "granite_moe":
        from repro_torch.models.moe import MoEConfig
        return ModelConfig(
            name=s.name, n_layers=s.n_layers, d_model=s.d_model,
            vocab=s.vocab, n_heads=s.n_heads, n_kv=s.n_kv, d_ff=0,
            rope_theta=s.rope_theta, tie_embeddings=s.tie,
            q_scale=s.attn_scale, param_dtype=param_dtype,
            moe=MoEConfig(n_experts=s.n_experts, top_k=s.top_k,
                          d_expert=s.d_expert,
                          capacity_factor=s.capacity_factor,
                          min_capacity=s.min_capacity,
                          dispatch_chunk=s.dispatch_chunk))
    if s.family == "mamba2":
        from repro_torch.models.mamba import MambaConfig
        return ModelConfig(
            name=s.name, n_layers=s.n_layers, d_model=s.d_model,
            vocab=s.vocab, d_ff=0, mixer="mamba", tie_embeddings=s.tie,
            param_dtype=param_dtype,
            mamba=MambaConfig(d_state=s.d_state, head_dim=s.m_head_dim,
                              n_groups=s.n_groups, d_conv=s.d_conv,
                              expand=s.d_inner // s.d_model, chunk=s.chunk))
    raise ValueError(s.family)


def port_params(model) -> Dict[str, list]:
    """Each leaf's parameters in the port's model: the per-layer
    parameters ``layers.<i>.<rest>`` under ``layers.<rest>``, layer 0
    first."""
    out: Dict[str, list] = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            out.setdefault(".".join(["layers", *parts[2:]]), []).append(
                (int(parts[1]), p))
        else:
            out[name] = [(0, p)]
    return {k: [p for _, p in sorted(v, key=lambda t: t[0])]
            for k, v in out.items()}


@torch.no_grad()
def build_model(s: Sizes, seed: int, device, dtype: torch.dtype):
    """The port's model (``repro_torch.models.lm.LM``) of sizes ``s``
    holding the weights of seed ``seed``, drawn leaf by leaf on
    ``device`` (:mod:`weights`)."""
    from repro_torch.models.lm import LM
    cfg = model_config(s, str(dtype).split(".")[-1])
    model = LM(cfg, device=device)
    params = port_params(model)
    specs = weights.leaves(s)
    if set(params) != {lf.name for lf in specs}:
        raise ValueError(f"the port's leaves {sorted(params)} are not the"
                         f" benchmark's {sorted(lf.name for lf in specs)}")
    for lf in specs:
        w = weights.draw(lf, seed, device, dtype)
        segs = params[lf.name]
        if lf.name.startswith("layers."):
            for p, wi in zip(segs, w.unbind(0)):
                p.copy_(wi)
        else:
            segs[0].copy_(w)
        del w
    return cfg, model


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


def build_kernels(names) -> None:
    """Build (first run in a checkout) or find the port's kernels."""
    if names:
        from repro_torch.kernels import build
        build.build(tuple(names))
