"""Weights drawn from ``--seed``, on the device, one generator call a leaf.

A leaf is one parameter of the model with its per-layer copies stacked
on a leading layer axis (``layers.attn.wq`` is (L, d, H, hd)).  Each
leaf is drawn whole by one call of a ``torch.Generator`` seeded from
(seed, leaf name), so that one leaf can be drawn again alone: the port
is handed the draws (``port.build_model``), and the plain reference
draws them again after the window.  Widths are the configuration's;
initialisers are the published models' kind (fan-in normals, unit
norms, Mamba-2's ``A_log`` and ``dt_bias`` from mamba_ssm's ranges).
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from .sizes import Sizes


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed from ``seed`` and ``tags``, for any whole ``seed``."""
    h = hashlib.sha256(repr((int(seed), *tags)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


@dataclass(frozen=True)
class Leaf:
    name: str
    shape: Tuple[int, ...]
    init: str            # normal | ones | zeros | a_log | dt_bias
    fan_in: int = 1
    f32: bool = False    # kept in f32 whatever the served dtype


def leaves(s: Sizes) -> List[Leaf]:
    """Every leaf of the model of ``s``, in a fixed order."""
    L, d = s.n_layers, s.d_model
    out = [Leaf("embed", (s.vocab, d), "normal", d),
           Leaf("final_norm", (d,), "ones")]
    if not s.tie:
        out.append(Leaf("head", (d, s.vocab), "normal", d))
    out.append(Leaf("layers.ln1", (L, d), "ones"))
    if s.family == "granite_moe":
        h, kv, hd, e, f = (s.n_heads, s.n_kv, s.head_dim, s.n_experts,
                           s.d_expert)
        out += [Leaf("layers.attn.wq", (L, d, h, hd), "normal", d),
                Leaf("layers.attn.wk", (L, d, kv, hd), "normal", d),
                Leaf("layers.attn.wv", (L, d, kv, hd), "normal", d),
                Leaf("layers.attn.wo", (L, h, hd, d), "normal", h * hd),
                Leaf("layers.ln2", (L, d), "ones"),
                Leaf("layers.moe.router", (L, d, e), "normal", d, True),
                Leaf("layers.moe.w_gate", (L, e, d, f), "normal", d),
                Leaf("layers.moe.w_up", (L, e, d, f), "normal", d),
                Leaf("layers.moe.w_down", (L, e, f, d), "normal", f)]
    elif s.family == "mamba2":
        di, nh, gn, k = s.d_inner, s.m_heads, s.n_groups * s.d_state, \
            s.d_conv
        m = "layers.mamba."
        out += [Leaf(m + "w_z", (L, d, di), "normal", d),
                Leaf(m + "w_x", (L, d, di), "normal", d),
                Leaf(m + "w_B", (L, d, gn), "normal", d),
                Leaf(m + "w_C", (L, d, gn), "normal", d),
                Leaf(m + "w_dt", (L, d, nh), "normal", d),
                Leaf(m + "conv_x", (L, k, di), "normal", k),
                Leaf(m + "conv_B", (L, k, gn), "normal", k),
                Leaf(m + "conv_C", (L, k, gn), "normal", k),
                Leaf(m + "conv_bx", (L, di), "zeros"),
                Leaf(m + "conv_bB", (L, gn), "zeros"),
                Leaf(m + "conv_bC", (L, gn), "zeros"),
                Leaf(m + "A_log", (L, nh), "a_log", 1, True),
                Leaf(m + "D", (L, nh), "ones", 1, True),
                Leaf(m + "dt_bias", (L, nh), "dt_bias", 1, True),
                Leaf(m + "norm", (L, di), "ones"),
                Leaf(m + "out_proj", (L, di, d), "normal", di)]
    else:
        raise ValueError(s.family)
    return out


def draw(leaf: Leaf, seed: int, device, dtype: torch.dtype) -> torch.Tensor:
    """Leaf ``leaf`` of seed ``seed``, in ``dtype`` (f32 for an f32
    leaf), drawn on ``device``; the same arguments give the same bits."""
    dt = torch.float32 if leaf.f32 else dtype
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=dt, device=device)
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=dt, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, leaf.name))
    if leaf.init == "normal":
        w = torch.randn(leaf.shape, generator=g, dtype=dt, device=device)
        return w.mul_(1.0 / math.sqrt(leaf.fan_in))
    u = torch.rand(leaf.shape, generator=g, dtype=torch.float32,
                   device=device)
    if leaf.init == "a_log":          # A in [1, 16), as mamba_ssm's
        return torch.log(1.0 + 15.0 * u)
    if leaf.init == "dt_bias":        # dt log-uniform in [1e-3, 1e-1)
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt_ = torch.exp(lo + (hi - lo) * u).clamp_min(1e-4)
        return dt_ + torch.log(-torch.expm1(-dt_))   # softplus^-1
    raise ValueError(leaf.init)


def all_leaves(s: Sizes, seed: int, device, dtype: torch.dtype
               ) -> Dict[str, torch.Tensor]:
    """Every leaf of seed ``seed`` (the plain reference's weights)."""
    return {lf.name: draw(lf, seed, device, dtype) for lf in leaves(s)}
