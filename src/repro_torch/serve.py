"""Serving on the port: prefill a batch of prompts, then decode greedily.

    python -m repro_torch.serve --arch llama3.2-1b --batch 4 \\
        --prompt-len 1024 --gen 32 --seed 0
    python -m repro_torch.serve --arch granite-moe-3b-a800m
    python -m repro_torch.serve --smoke --device cpu

The port's counterpart of the JAX package's
``examples/serve_pipelined.py``, for every architecture (dense GQA,
qwen2-vl's M-RoPE with the vision stub, musicgen's audio stub, MLA,
Mamba-2, MoE, the Hymba hybrid).  Weights are random, drawn from a
``torch.Generator`` seeded with ``--seed``; prompts are seeded too.
qwen2-vl's prompts are tokens with 64 seeded patch embeddings (the data
stream's ``n_patches``) over the first positions, under JAX's default
positions.  musicgen's are seeded frame embeddings (B, S, d), and each
decode step takes the next seeded (B, 1, d) frame: the EnCodec frontend
is a stub in both packages, so the argmax codes are recorded but not
fed back.  The model is first built in f32 and checked: prefilling a
short prompt must give the same last-token logits as decoding it token
by token (64 tokens, ``< 2e-2``; qwen2-vl's check is text only, as
JAX's decode takes no patches).  Where the card's free memory cannot hold
the f32 weights of every layer (moonshot-v1-16b-a3b: 112 GB), the check
runs on the first layers that fit, and the served model is built in the
serving dtype directly.  The model, in the serving dtype (bf16),
prefills ``--batch`` prompts of ``--prompt-len`` tokens into a cache of
``prompt_len + gen`` positions and decodes ``--gen`` tokens greedily.
Prints the generated tokens and the prefill and decode times (host
clock, device synchronised, after a warm-up run that builds the kernel).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .configs import ARCH_IDS, get_config, get_smoke_config
from .core.fabric_torch import resolve_device
from .launch.steps import (StepConfig, make_cache, make_decode_step,
                           make_prefill_step)
from .models import lm

CONSISTENCY_TOL = 2e-2
CHECK_LEN = 64  # prompt length of the prefill/decode check
N_PATCHES = 64  # the data stream's patch count (data.pipeline.DataConfig)


def build_model(cfg: lm.ModelConfig, seed: int, device="cuda",
                dtype=None) -> lm.LM:
    """The model of ``cfg`` in ``dtype`` (default ``cfg.param_dtype``),
    its weights drawn in f32 from a generator on ``device`` seeded with
    ``seed`` (so a model built in bf16 equals the f32 one cast, and a
    model with fewer layers equals the first layers of a deeper one)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return lm.init_params(cfg, gen, device=dev, dtype=dtype)


def check_layers(cfg: lm.ModelConfig, device) -> int:
    """Layers of the f32 prefill/decode check: all of them, or on a card
    whose free memory cannot hold the f32 weights of every layer with a
    quarter to spare, as many as fit."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return cfg.n_layers
    fixed = 4 * cfg.replace(n_layers=0).param_count(padded=True)
    per_layer = (4 * cfg.param_count(padded=True) - fixed) / cfg.n_layers
    budget = 0.75 * torch.cuda.mem_get_info(dev)[0] - fixed
    return max(1, min(cfg.n_layers, int(budget // per_layer)))


def make_prompts(cfg: lm.ModelConfig, batch: int, length: int, seed: int,
                 device="cuda") -> torch.Tensor:
    """Seeded prompts: tokens (batch, length) int64, or for the audio
    stub frame embeddings (batch, length, d) f32 (standard normal, as
    the data stream's)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_stub":
        x = rng.standard_normal((batch, length, cfg.d_model),
                                dtype=np.float32)
    else:
        x = rng.integers(0, cfg.vocab, size=(batch, length))
    return torch.from_numpy(x).to(resolve_device(device))


def serving_inputs(cfg: lm.ModelConfig, batch: int, length: int, gen: int,
                   seed: int, device="cuda") -> Tuple[torch.Tensor, Dict]:
    """``(prompts, extra)`` of a serving run, for
    ``generate(cfg, scfg, params, prompts, gen, **extra)``: the seeded
    prompts; for the vision stub ``patch_embeds`` (batch, 64, d) seeded
    with ``seed + 1``; for the audio stub the ``frames`` (batch, gen, d)
    its decode steps take, which continue the prompt's seeded stream."""
    if cfg.frontend == "audio_stub":
        x = make_prompts(cfg, batch, length + gen, seed, device)
        return x[:, :length], {"frames": x[:, length:]}
    prompts = make_prompts(cfg, batch, length, seed, device)
    if cfg.frontend == "vision_stub":
        rng = np.random.default_rng(seed + 1)
        pe = rng.standard_normal((batch, N_PATCHES, cfg.d_model),
                                 dtype=np.float32)
        return prompts, {"patch_embeds":
                         torch.from_numpy(pe).to(prompts.device)}
    return prompts, {}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check_consistency(cfg: lm.ModelConfig, params: lm.LM,
                      prompt: torch.Tensor) -> float:
    """Max |logit| difference between prefilling ``prompt`` (tokens, or
    the audio stub's frame embeddings) and decoding it token by token
    (frame by frame), both into a cache of the parameter dtype.  An MoE
    runs with ``capacity_factor = n_experts / top_k``, which drops no
    slot: under capacity drops a prefill (its chunk's capacity) and a
    decode step (``min_capacity``) route differently, in the JAX package
    too."""
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    b, s = prompt.shape[:2]
    dev = prompt.device
    audio = lm.input_key(cfg) == "embeds"
    logits_p, _ = lm.prefill(cfg, params, lm.input_batch(cfg, prompt),
                             cache=lm.init_cache(cfg, b, s, device=dev))
    cache = lm.init_cache(cfg, b, s, device=dev)
    for t in range(s):
        logits_i, cache = lm.decode_step(
            cfg, params, cache, None if audio else prompt[:, t], t,
            embeds=prompt[:, t:t + 1] if audio else None)
    return float((logits_p - logits_i).abs().max())


def generate(cfg: lm.ModelConfig, scfg: StepConfig, params: lm.LM,
             prompts: torch.Tensor, gen: int, *,
             patch_embeds: Optional[torch.Tensor] = None,
             frames: Optional[torch.Tensor] = None) -> Dict:
    """Prefill ``prompts`` (with ``patch_embeds`` for the vision stub)
    into a cache of ``prompt_len + gen`` positions, then decode ``gen``
    tokens greedily; the audio stub's steps take ``frames`` (batch, gen,
    d) instead of their tokens.  Returns the prefill logits, the decoded
    tokens (batch, gen) (the argmax fed to each decode step, as the JAX
    example records them; for the audio stub recorded only), and host
    times."""
    b, s = prompts.shape[:2]
    dev = prompts.device
    max_len = s + gen
    audio = lm.input_key(cfg) == "embeds"
    if audio and gen and (frames is None or frames.shape[1] < gen):
        raise ValueError(f"{cfg.name}: decoding {gen} steps needs {gen}"
                         f" frames (batch, {gen}, d)")
    batch = lm.input_batch(cfg, prompts, patch_embeds=patch_embeds)
    prefill_step = make_prefill_step(cfg, scfg, seq_len=s, batch=b,
                                     device=dev)
    decode_step = make_decode_step(cfg, scfg, seq_len=max_len, batch=b,
                                   device=dev)
    cache = make_cache(cfg, scfg, batch=b, max_len=max_len, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits_p, cache = prefill_step(params, batch, cache)
    _sync(dev)
    t1 = time.perf_counter()
    tok = logits_p[:, :cfg.vocab].argmax(dim=-1)
    toks = []
    for i, t in enumerate(range(s, max_len)):
        toks.append(tok)
        logits, cache = decode_step(
            params, cache, tok, t,
            embeds=frames[:, i:i + 1] if audio else None)
        tok = logits[:, :cfg.vocab].argmax(dim=-1)
    _sync(dev)
    t2 = time.perf_counter()
    return {"prefill_logits": logits_p,
            "tokens": torch.stack(toks, dim=1) if toks else
            torch.empty((b, 0), dtype=torch.long, device=dev),
            "prefill_ms": (t1 - t0) * 1e3,
            "decode_ms_per_token": (t2 - t1) * 1e3 / max(gen, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced smoke config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    n_check = check_layers(cfg, dev)
    check_cfg = cfg.replace(n_layers=n_check)
    params = build_model(check_cfg, args.seed, dev)
    check = make_prompts(cfg, 2, CHECK_LEN, args.seed + 1, dev)
    err = check_consistency(check_cfg, params, check)
    if not err < CONSISTENCY_TOL:
        print(f"prefill/decode mismatch: max|dlogit| = {err!r}",
              file=sys.stderr)
        return 1
    scfg = StepConfig()
    serve_dtype = getattr(torch, scfg.param_dtype)
    if n_check == cfg.n_layers:
        params = lm.cast(params, serve_dtype)
    else:
        del params
        torch.cuda.empty_cache()
        params = build_model(cfg, args.seed, dev, serve_dtype)
    prompts, extra = serving_inputs(cfg, args.batch, args.prompt_len,
                                    args.gen, args.seed + 2, dev)
    # warm-up: the kernel's build, the allocator
    generate(cfg, scfg, params, prompts, min(args.gen, 1), **extra)
    out = generate(cfg, scfg, params, prompts, args.gen, **extra)
    print(json.dumps({
        "arch": cfg.name, "device": str(dev),
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "dtype": scfg.param_dtype, "batch": args.batch,
        "prompt_len": args.prompt_len, "gen": args.gen,
        "prefill_decode_max_abs_err": err, "check_layers": n_check,
        "prefill_ms": out["prefill_ms"],
        "decode_ms_per_token": out["decode_ms_per_token"],
        "tokens": out["tokens"].cpu().tolist()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
