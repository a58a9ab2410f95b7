"""Plain PyTorch pieces shared by the references: norm, rotary
embedding, SiLU, the matrix product in a stated precision, cross
entropy, AdamW and its schedule, and the samples of a model's slices
that a training cell compares.

Nothing here imports the port; which layers a leaf covers comes from
the benchmark's own leaf list (``weights.py``).  ``precision`` is
``"f32"`` (float32, TF32 off: the caller sets ``torch.backends``'
flags), ``"tf32"`` (the same products with TF32 on: the caller sets
the flags) or ``"fp8"`` (every projection's operands rounded to float8
e4m3, the weight by output column and the activation by row, each with
its own scale: W8A8 serving, the step below bfloat16).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..weights import layer_slots

FP8_MAX = 448.0   # largest finite float8 e4m3 value


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * w.float()


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D), pos (S,): each half-pair (i, i + D/2) rotated by
    pos * theta^(-2i/D)."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = pos.float()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (its absolute maximum mapped to 448), back in f32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = FP8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def linear(x: torch.Tensor, w: torch.Tensor, precision: str = "f32"
           ) -> torch.Tensor:
    """x (..., n) @ w (n, m) in f32, or with both operands in fp8."""
    x, w = x.float(), w.float()
    if precision == "fp8":
        x, w = _fp8(x, -1), _fp8(w, 0)
    return x @ w


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean next-token cross entropy over every position, f32."""
    lg = logits.float().reshape(-1, logits.shape[-1])
    return torch.nn.functional.cross_entropy(lg, labels.reshape(-1).long())


def lr_at(step: int, sch: dict) -> float:
    """Linear warm-up from 0, then cosine decay to ``min_ratio``."""
    peak, warm, total = sch["peak_lr"], sch["warmup_steps"], \
        sch["total_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    frac = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (sch["min_ratio"] + (1 - sch["min_ratio"]) * 0.5
                   * (1.0 + math.cos(math.pi * frac)))


@torch.no_grad()
def adamw_step(params: dict, grads: dict, m: dict, v: dict, step: int,
               lr: float, cfg: dict) -> None:
    """AdamW with the gradient clipped to a global norm: ``step`` is the
    1-based count, ``u = (m / c1) / (sqrt(v / c2) + eps)`` and ``p <- p
    - lr (u + wd p)``, in place, in f32."""
    gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
    scale = min(cfg["clip_norm"] / max(gnorm.item(), 1e-12), 1.0) \
        if cfg["clip_norm"] > 0 else 1.0
    c1, c2 = 1.0 - cfg["b1"] ** step, 1.0 - cfg["b2"] ** step
    for k, p in params.items():
        g = grads[k].float() * scale
        m[k].mul_(cfg["b1"]).add_(g, alpha=1.0 - cfg["b1"])
        v[k].mul_(cfg["b2"]).add_(g.square(), alpha=1.0 - cfg["b2"])
        u = (m[k] / c1) / ((v[k] / c2).sqrt() + cfg["eps"])
        p.sub_(lr * (u + cfg["weight_decay"] * p))


SAMPLE = 4096                                   # elements kept a slice
EXPERT_LEAVES = ("moe.w_gate", "moe.w_up", "moe.w_down")


def at(s, W: Dict[str, torch.Tensor], name: str, i: int) -> torch.Tensor:
    """Layer ``i``'s slice of the per-layer leaf ``name``, by global
    layer index: a leaf's rows are the layers it covers
    (``weights.layer_slots``)."""
    return W[name][layer_slots(s)[name][i]]


def per_layer(s, W: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Stacked leaves ``layers.<rest>`` as one tensor a layer, named
    ``layers.<i>.<rest>`` by global layer index; the other leaves as
    they are."""
    slots = layer_slots(s)
    out = {}
    for k, t in W.items():
        if k in slots:
            rest = k[len("layers."):]
            out.update((f"layers.{i}.{rest}", t[j])
                       for i, j in slots[k].items())
        else:
            out[k] = t
    return out


@torch.no_grad()
def slice_samples(named: Dict[str, torch.Tensor], scale: float = 1.0
                  ) -> Dict[str, torch.Tensor]:
    """A fixed strided sample of at most :data:`SAMPLE` elements of each
    slice, f32 on the host: a slice is one layer's parameter, or one
    expert's block of an expert leaf."""
    names, parts = [], []
    for k, t in named.items():
        blocks = [(f"{k}.{e}", t[e]) for e in range(t.shape[0])] \
            if k.endswith(EXPERT_LEAVES) else [(k, t)]
        for name, x in blocks:
            flat = x.detach().reshape(-1)
            step = max(1, flat.numel() // SAMPLE)
            names.append(name)
            parts.append(flat[::step][:SAMPLE].float())
    if not parts:
        return {}
    host = (torch.cat(parts) * scale).cpu()
    return dict(zip(names, host.split([x.numel() for x in parts])))
