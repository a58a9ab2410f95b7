"""Plain reference of a Mamba-2 decoder (arXiv:2405.21060), in f32.

Pre-norm blocks ``h += mixer(norm(h))``, a final norm and the head (the
embedding's transpose when tied).  The mixer: projections z, x, B, C
and dt; a depthwise causal convolution of width ``d_conv`` with bias,
then SiLU, on each of x, B and C; ``dt = softplus(x W_dt + dt_bias)``,
``A = -exp(A_log)``; the selective state-space recurrence per head

    s_t = exp(dt_t A) s_{t-1} + dt_t x_t B_t^T,   y_t = s_t C_t + D x_t

(B and C shared by the heads of a group), computed a block of ``BLOCK``
positions at a time: inside a block by the decays between every pair of
positions, across blocks by the carried state.  Then the gated norm
``norm(y * silu(z))`` over d_inner and the output projection.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .common import at, linear, rms_norm, silu

BLOCK = 64


def conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution of u (B, S, C) by w (K, C), bias b,
    then SiLU."""
    k, c = w.shape
    y = F.conv1d(F.pad(u.transpose(1, 2), (k - 1, 0)),
                 w.float().T.reshape(c, 1, k), b.float(), groups=c)
    return silu(y.transpose(1, 2))


def scan(x, dt, A, Bm, Cm, D) -> torch.Tensor:
    """x (b, S, H, P), dt (b, S, H), A (H,), Bm, Cm (b, S, H, N), D (H,)
    -> y (b, S, H, P), from a zero state."""
    b, n, h, p = x.shape
    state = x.new_zeros((b, h, p, Bm.shape[-1]))
    ys = []
    for t0 in range(0, n, BLOCK):
        xs, ds = x[:, t0:t0 + BLOCK], dt[:, t0:t0 + BLOCK]
        bs, cs = Bm[:, t0:t0 + BLOCK], Cm[:, t0:t0 + BLOCK]
        q = xs.shape[1]
        a = torch.cumsum(ds * A, dim=1)                         # (b,q,h)
        diff = a[:, :, None, :] - a[:, None, :, :]              # (b,t,s,h)
        causal = torch.ones(q, q, dtype=torch.bool,
                            device=x.device).tril()[None, :, :, None]
        decay = torch.exp(diff.masked_fill(~causal, float("-inf")))
        w = torch.einsum("bthn,bshn->btsh", cs, bs) * decay
        xd = xs * ds[..., None]
        y = torch.einsum("btsh,bshp->bthp", w, xd)
        y = y + torch.einsum("bthn,bhpn->bthp", cs, state) \
            * torch.exp(a)[..., None]
        ys.append(y + xs * D[:, None])
        last = torch.exp(a[:, -1:] - a)                         # (b,q,h)
        state = state * torch.exp(a[:, -1])[..., None, None] \
            + torch.einsum("bsh,bshp,bshn->bhpn", last, xd, bs)
    return torch.cat(ys, dim=1)


def mixer(s, W: Dict, i: int, x: torch.Tensor, precision: str
          ) -> torch.Tensor:
    m = lambda k: at(s, W, f"layers.mamba.{k}", i)   # noqa: E731
    b, n, _ = x.shape
    h, p, g, N = s.m_heads, s.m_head_dim, s.n_groups, s.d_state
    z = linear(x, m("w_z"), precision)
    xs = conv(linear(x, m("w_x"), precision), m("conv_x"), m("conv_bx"))
    Bm = conv(linear(x, m("w_B"), precision), m("conv_B"), m("conv_bB"))
    Cm = conv(linear(x, m("w_C"), precision), m("conv_C"), m("conv_bC"))
    dt = F.softplus(linear(x, m("w_dt"), precision) + m("dt_bias").float())
    A = -torch.exp(m("A_log").float())
    grp = torch.arange(h, device=x.device) // (h // g)
    Bh = Bm.reshape(b, n, g, N)[:, :, grp]
    Ch = Cm.reshape(b, n, g, N)[:, :, grp]
    y = scan(xs.reshape(b, n, h, p), dt, A, Bh, Ch, m("D").float())
    y = rms_norm(y.reshape(b, n, h * p) * silu(z), m("norm"), s.eps)
    return linear(y, m("out_proj"), precision)


def layer(s, W: Dict, i: int, h: torch.Tensor, precision: str
          ) -> torch.Tensor:
    return h + mixer(s, W, i, rms_norm(h, at(s, W, "layers.ln1", i),
                                       s.eps), precision)


def head(s, W: Dict) -> torch.Tensor:
    return W["embed"].T if s.tie else W["head"]
