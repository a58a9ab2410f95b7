"""Serving on the port: prefill a batch of prompts, then decode greedily.

    python -m repro_torch.serve --arch llama3.2-1b --batch 4 \\
        --prompt-len 1024 --gen 32 --seed 0
    python -m repro_torch.serve --arch granite-moe-3b-a800m
    python -m repro_torch.serve --smoke --device cpu

The port's counterpart of the JAX package's
``examples/serve_pipelined.py``, for every ported architecture (dense
GQA, MLA, Mamba-2, MoE, the Hymba hybrid).  Weights are random, drawn
from a ``torch.Generator`` seeded with ``--seed``; prompts are seeded
too.  The model is first built in f32 and checked: prefilling a short
prompt must give the same last-token logits as decoding it token by
token (64 tokens, ``< 2e-2``).  Where the card's free memory cannot hold
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
from typing import Dict

import numpy as np
import torch

from .configs import ARCH_IDS, get_config, get_smoke_config
from .core.fabric_torch import resolve_device
from .launch.steps import (StepConfig, make_cache, make_decode_step,
                           make_prefill_step)
from .models import lm

CONSISTENCY_TOL = 2e-2
CHECK_LEN = 64  # prompt length of the prefill/decode check


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
    """Seeded prompt tokens, (batch, length) int64."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(batch, length))
    return torch.from_numpy(toks).to(resolve_device(device))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check_consistency(cfg: lm.ModelConfig, params: lm.LM,
                      prompt: torch.Tensor) -> float:
    """Max |logit| difference between prefilling ``prompt`` and decoding
    it token by token, both into a cache of the parameter dtype.  An MoE
    runs with ``capacity_factor = n_experts / top_k``, which drops no
    slot: under capacity drops a prefill (its chunk's capacity) and a
    decode step (``min_capacity``) route differently, in the JAX package
    too."""
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    b, s = prompt.shape
    dev = prompt.device
    logits_p, _ = lm.prefill(cfg, params, {"tokens": prompt},
                             cache=lm.init_cache(cfg, b, s, device=dev))
    cache = lm.init_cache(cfg, b, s, device=dev)
    for t in range(s):
        logits_i, cache = lm.decode_step(cfg, params, cache, prompt[:, t], t)
    return float((logits_p - logits_i).abs().max())


def generate(cfg: lm.ModelConfig, scfg: StepConfig, params: lm.LM,
             prompts: torch.Tensor, gen: int) -> Dict:
    """Prefill ``prompts`` into a cache of ``prompt_len + gen``
    positions, then decode ``gen`` tokens greedily.  Returns the prefill
    logits, the decoded tokens (batch, gen) (the tokens fed to each
    decode step, as the JAX example records them), and host times."""
    b, s = prompts.shape
    dev = prompts.device
    max_len = s + gen
    prefill_step = make_prefill_step(cfg, scfg, seq_len=s, batch=b,
                                     device=dev)
    decode_step = make_decode_step(cfg, scfg, seq_len=max_len, batch=b,
                                   device=dev)
    cache = make_cache(cfg, scfg, batch=b, max_len=max_len, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits_p, cache = prefill_step(params, prompts, cache)
    _sync(dev)
    t1 = time.perf_counter()
    tok = logits_p[:, :cfg.vocab].argmax(dim=-1)
    toks = []
    for t in range(s, max_len):
        toks.append(tok)
        logits, cache = decode_step(params, cache, tok, t)
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
    prompts = make_prompts(cfg, args.batch, args.prompt_len, args.seed + 2,
                           dev)
    generate(cfg, scfg, params, prompts, 1)  # warm-up: build, allocator
    out = generate(cfg, scfg, params, prompts, args.gen)
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
