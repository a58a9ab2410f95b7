"""Serving steps (prefill and decode) on one device.

The port's counterpart of the serving half of the JAX package's
``launch/steps.py``.  ``StepConfig`` keeps the serving fields
(``param_dtype``, ``cache_dtype``); ``make_prefill_step`` and
``make_decode_step`` return plain callables that check their inputs and
run ``lm.prefill`` / ``lm.decode_step``.  The mesh, tensor- and sequence-parallel sharding
and the partitioned-KV ``flash_decode`` need several devices and are not
ported yet (ROADMAP queue 1, item 9); training steps wait for the
training slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from ..core.fabric_torch import resolve_device
from ..models import lm


@dataclass(frozen=True)
class StepConfig:
    param_dtype: str = "bfloat16"
    cache_dtype: str = "bfloat16"


def make_cache(cfg: lm.ModelConfig, scfg: StepConfig, *, batch: int,
               max_len: int, device="cuda") -> Dict[str, torch.Tensor]:
    """A zeroed cache of ``max_len`` positions in the step's cache dtype."""
    return lm.init_cache(cfg, batch, max_len,
                         getattr(torch, scfg.cache_dtype), device=device)


def _check_cache(cache, scfg: StepConfig, batch: int, need: int) -> None:
    k = cache["k"]
    if k.dtype != getattr(torch, scfg.cache_dtype) or k.shape[1] != batch \
            or k.shape[2] < need:
        raise ValueError(
            f"cache {k.dtype} {tuple(k.shape)} does not hold batch {batch}"
            f" and {need} positions in {scfg.cache_dtype}")


def make_prefill_step(cfg: lm.ModelConfig, scfg: StepConfig, *,
                      seq_len: int, batch: int, device="cuda") -> Callable:
    """``prefill_step(params, tokens (batch, seq_len), cache) ->
    (logits (batch, V) f32, cache)``; the cache is written in place."""
    cfg = cfg.replace(param_dtype=scfg.param_dtype)
    dev = resolve_device(device)

    def prefill_step(params: lm.LM, tokens: torch.Tensor, cache
                     ) -> Tuple[torch.Tensor, Dict]:
        if tuple(tokens.shape) != (batch, seq_len) \
                or tokens.device.type != dev.type:
            raise ValueError(f"prefill_step: tokens {tuple(tokens.shape)} on"
                             f" {tokens.device}, need ({batch}, {seq_len})"
                             f" on {dev}")
        _check_cache(cache, scfg, batch, seq_len)
        return lm.prefill(cfg, params, {"tokens": tokens}, cache=cache)

    return prefill_step


def make_decode_step(cfg: lm.ModelConfig, scfg: StepConfig, *,
                     seq_len: int, batch: int, device="cuda") -> Callable:
    """``decode_step(params, cache, tokens (batch,), pos) -> (logits
    (batch, V) f32, cache)``; ``seq_len`` is the cache length, one new
    token is decoded at write offset ``pos``."""
    cfg = cfg.replace(param_dtype=scfg.param_dtype)
    dev = resolve_device(device)

    def decode_step(params: lm.LM, cache, tokens: torch.Tensor, pos: int
                    ) -> Tuple[torch.Tensor, Dict]:
        if tuple(tokens.shape) != (batch,) \
                or tokens.device.type != dev.type:
            raise ValueError(f"decode_step: tokens {tuple(tokens.shape)} on"
                             f" {tokens.device}, need ({batch},) on {dev}")
        if not 0 <= pos < seq_len:
            raise ValueError(f"decode_step: position {pos} outside the"
                             f" cache of {seq_len}")
        _check_cache(cache, scfg, batch, seq_len)
        return lm.decode_step(cfg, params, cache, tokens, pos)

    return decode_step
