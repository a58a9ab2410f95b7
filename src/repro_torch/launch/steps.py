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
sequence.  Every rank still holds the whole cache: the mesh, tensor-
and sequence-parallel sharding (the cache's among them) and ZeRO-1 are
not ported yet (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..compat import axis_index, axis_size
from ..core.earlybird import SyncConfig, value_and_synced_grad
from ..core.fabric_torch import resolve_device
from ..core.flash_decode import flash_decode_shard
from ..models import lm
from ..optim.adamw import AdamWConfig, adamw_update, init_opt_state
from ..optim.schedule import warmup_cosine


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


def build_state(cfg: lm.ModelConfig, seed: int = 0, device="cuda",
                adam: AdamWConfig = AdamWConfig()) -> Dict[str, Any]:
    """A fresh training state ``{"params", "opt"}``: the model of
    ``cfg`` with weights drawn from a generator on ``device`` seeded
    with ``seed``, requiring gradients, and zero AdamW moments."""
    dev = resolve_device(device)
    model = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    model.requires_grad_(True)
    return {"params": model,
            "opt": init_opt_state(dict(model.named_parameters()), adam)}


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
                    batch: int, group=None, device="cuda") -> Callable:
    """``step_fn(state, batch) -> (state, loss)``: one training step on
    this rank's ``batch`` rows of ``seq_len`` tokens; ``state`` =
    ``{"params": LM, "opt": ...}`` is updated in place and returned.
    ``group`` is the data-parallel process group (None: the default
    group, which must be initialised).  ``step_fn.log`` is the
    :class:`~repro_torch.core.earlybird.SyncLog` of the last step."""
    cfg = cfg.replace(param_dtype=scfg.param_dtype)
    dev = resolve_device(device)
    sync = SyncConfig(mode=scfg.sync_mode, group=group,
                      aggr_bytes=scfg.aggr_bytes, comm_dtype=scfg.comm_dtype)

    def local_loss(model, b, param_hook):
        return lm.loss_fn(cfg, model, b, remat=scfg.remat,
                          param_hook=param_hook,
                          gather_targets=scfg.ce_gather_targets)

    vg = value_and_synced_grad(local_loss, sync)

    def step_fn(state: Dict[str, Any], b: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, Any], torch.Tensor]:
        _check_batch("train_step", cfg, b, batch, seq_len, dev,
                     labels=True)
        model = state["params"]
        loss, grads = vg(model, b)
        step_fn.log = vg.log
        lr = warmup_cosine(state["opt"]["step"], peak_lr=scfg.peak_lr,
                           warmup_steps=scfg.warmup_steps,
                           total_steps=scfg.total_steps)
        adamw_update(dict(model.named_parameters()), grads, state["opt"],
                     lr, scfg.adam)
        return state, loss

    step_fn.log = vg.log
    return step_fn


def make_cache(cfg: lm.ModelConfig, scfg: StepConfig, *, batch: int,
               max_len: int, device="cuda") -> Dict[str, torch.Tensor]:
    """A zeroed cache of ``max_len`` positions in the step's cache dtype."""
    return lm.init_cache(cfg, batch, max_len,
                         getattr(torch, scfg.cache_dtype), device=device)


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


def make_prefill_step(cfg: lm.ModelConfig, scfg: StepConfig, *,
                      seq_len: int, batch: int, device="cuda") -> Callable:
    """``prefill_step(params, batch, cache) -> (logits (batch, V) f32,
    cache)``, the cache written in place.  ``batch`` is the JAX step's
    dict: ``tokens`` (batch, seq_len), or ``embeds`` (batch, seq_len, d)
    for the audio stub; optionally ``patch_embeds`` and ``positions``.
    A tensor is taken as the model input (:func:`lm.input_batch`)."""
    cfg = cfg.replace(param_dtype=scfg.param_dtype)
    dev = resolve_device(device)

    def prefill_step(params: lm.LM, b, cache) -> Tuple[torch.Tensor, Dict]:
        if isinstance(b, torch.Tensor):
            b = lm.input_batch(cfg, b)
        _check_batch("prefill_step", cfg, b, batch, seq_len, dev)
        _check_cache(cache, scfg, batch, seq_len)
        return lm.prefill(cfg, params, b, cache=cache)

    return prefill_step


def _flash_decode_fn(group) -> Callable:
    """The partitioned-KV decode hook (``attention_fwd``'s
    ``decode_attn``): rank r of ``group``'s N takes the sequence slice
    [r S/N, (r+1) S/N) of the cache, and ``flash_decode_shard`` combines
    the partitions -- the paper's partition-consume pattern on the
    inference side.  The compute is split as in the JAX package's
    shard_map; the cache itself is not (every rank holds all of it)."""
    def hook(q, k, v, *, pos, window, attn_softcap, scale):
        n, r = axis_size(group), axis_index(group)
        s = k.shape[1]
        if s % n:
            raise ValueError(f"flash_decode: a cache of {s} positions does"
                             f" not split over {n} ranks")
        sl = slice(r * (s // n), (r + 1) * (s // n))
        return flash_decode_shard(q, k[:, sl], v[:, sl], group=group,
                                  pos=pos, window=window,
                                  attn_softcap=attn_softcap, scale=scale)
    return hook


def make_decode_step(cfg: lm.ModelConfig, scfg: StepConfig, *,
                     seq_len: int, batch: int, device="cuda",
                     group=None) -> Callable:
    """``decode_step(params, cache, tokens (batch,), pos, embeds=None)
    -> (logits (batch, V) f32, cache)``; ``seq_len`` is the cache
    length, one new token is decoded at write offset ``pos``.  The
    audio stub decodes from ``embeds`` (batch, 1, d) instead of
    tokens.  With ``scfg.flash_decode`` the attention layers decode
    through the partitioned-KV flash decode over the process group
    ``group`` (None: the default group, which must be initialised; every
    rank calls the step with the same inputs); ``seq_len`` must split
    evenly over its ranks."""
    cfg = cfg.replace(param_dtype=scfg.param_dtype)
    dev = resolve_device(device)
    key = lm.input_key(cfg)
    decode_attn = None
    if scfg.flash_decode:
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
        _check_cache(cache, scfg, batch, seq_len)
        return lm.decode_step(cfg, params, cache, tokens, pos, embeds=embeds,
                              decode_attn=decode_attn)

    return decode_step
