"""Mamba-2 (SSD, state-space duality) mixer.

The port's counterpart of the JAX package's ``models/mamba.py``: the
chunked SSD algorithm of the Mamba-2 paper (arXiv:2405.21060).  The
sequence is split into chunks; intra-chunk terms are masked matrix
products and inter-chunk terms a short loop over chunk states (the JAX
package's ``lax.scan``).  That is the path autograd records (training);
where it records nothing (the served prefill) the scan goes through
``kernels.ops.ssd_scan``, the same function as hand-written kernels on
the card and as :func:`ssd_chunked` on the CPU.  Decode carries a
constant-size recurrent state and the last ``d_conv - 1`` inputs of
each causal convolution.

Parameters keep the JAX names and shapes: the projections are stored
split (``w_z``, ``w_x``, ``w_B``, ``w_C``, ``w_dt``), the depthwise
convolutions ``conv_x``/``conv_B``/``conv_C`` are ``(d_conv, C)`` with
biases ``conv_b*``, and ``A_log``, ``D`` and ``dt_bias`` are always f32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import telemetry
from ..kernels import ops
from .layers import dense_init, rms_norm, silu
from .tp import psum


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    head_dim: int = 64
    n_groups: int = 1
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        di = self.d_inner(d_model)
        if di % self.head_dim != 0:
            raise ValueError(f"d_inner {di} is not a multiple of head_dim"
                             f" {self.head_dim}")
        return di // self.head_dim


# Leaves the JAX package keeps in f32 whatever the parameter dtype.
F32_LEAVES = ("A_log", "D", "dt_bias")


class Mamba(nn.Module):
    """The SSD mixer's parameters, allocated uninitialised;
    :func:`init_mamba` fills them."""

    def __init__(self, d_model: int, mc: MambaConfig, *, dtype, device):
        super().__init__()

        def p(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                requires_grad=False)
        di = mc.d_inner(d_model)
        nh = mc.n_heads(d_model)
        gn = mc.n_groups * mc.d_state
        self.w_z = p(d_model, di)
        self.w_x = p(d_model, di)
        self.w_B = p(d_model, gn)
        self.w_C = p(d_model, gn)
        self.w_dt = p(d_model, nh)
        self.conv_x = p(mc.d_conv, di)
        self.conv_B = p(mc.d_conv, gn)
        self.conv_C = p(mc.d_conv, gn)
        self.conv_bx = p(di)
        self.conv_bB = p(gn)
        self.conv_bC = p(gn)
        for name in F32_LEAVES:
            setattr(self, name, p(nh, dt=torch.float32))
        self.norm = p(di)
        self.out_proj = p(di, d_model)


@torch.no_grad()
def init_mamba(p: Mamba, gen: torch.Generator) -> Mamba:
    """The JAX package's initialisers: fan-in truncated normals for the
    projections, ``0.1 * N(0, 1)`` convolution taps, zero biases,
    ``A_log = log(linspace(1, 16, nh))``, ``D = 1``, ``dt_bias = 0`` and
    a unit norm."""
    d_model = p.w_z.shape[0]
    dt = p.w_z.dtype
    for w in (p.w_z, p.w_x, p.w_B, p.w_C, p.w_dt):
        w.copy_(dense_init(gen, d_model, w.shape[1:], dt))
    for w in (p.conv_x, p.conv_B, p.conv_C):
        w.copy_(0.1 * torch.randn(w.shape, dtype=torch.float32,
                                  device=gen.device, generator=gen))
    for b in (p.conv_bx, p.conv_bB, p.conv_bC):
        b.zero_()
    nh = p.A_log.shape[0]
    p.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, nh,
                                           dtype=torch.float32)))
    p.D.fill_(1.0)
    p.dt_bias.zero_()
    p.norm.fill_(1.0)
    p.out_proj.copy_(dense_init(gen, p.out_proj.shape[0], (d_model,), dt))
    return p


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): seg[i, j] = sum_{k=j+1..i} x_k, -inf
    above the diagonal (set before any ``exp``)."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, -torch.inf)


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal convolution along the sequence: u (B, S, C),
    w (K, C), then SiLU."""
    k, s = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = 0
    for i in range(k):
        out = out + pad[:, i:i + s, :] * w[i]
    return silu(out + b)


def _conv_step(u_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token of the causal convolution: u_t (B, 1, C), conv_state
    (B, K-1, C) -> (out (B, C), the new conv state)."""
    full = torch.cat([conv_state.to(u_t.dtype), u_t], dim=1)  # (B, K, C)
    out = silu(torch.einsum("bkc,kc->bc", full, w) + b)
    return out, full[:, 1:, :]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                chunk: int, init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x: (b, l, h, p); dt: (b, l, h) (post-softplus, > 0); A: (h,)
    negative; B, C: (b, l, g, n) with g | h; D: (h,).  Returns
    (y (b, l, h, p), final state (b, h, p, n)).
    """
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    chunk = min(chunk, l)
    pad = (-l) % chunk
    l_orig = l
    if pad:
        # zero-pad the tail: dt = 0 rows decay by exp(0) = 1 and add
        # x * dt = 0, so states and outputs stay exact
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        l = l + pad
    c = l // chunk
    rep = h // g

    dA = dt * A                                                   # (b,l,h)
    xdt = x * dt[..., None]

    dA_c = dA.reshape(b, c, chunk, h).permute(0, 1, 3, 2)        # (b,c,h,Q)
    x_c = xdt.reshape(b, c, chunk, h, p)                         # (b,c,Q,h,p)
    B_c = B.reshape(b, c, chunk, g, n).repeat_interleave(rep, dim=3)
    C_c = C.reshape(b, c, chunk, g, n).repeat_interleave(rep, dim=3)

    # intra-chunk terms, quadratic in Q
    L = torch.exp(_segsum(dA_c))                                 # (b,c,h,Q,Q)
    scores = torch.einsum("bcqhn,bcshn->bchqs", C_c, B_c)
    y_diag = torch.einsum("bchqs,bcshp->bcqhp", scores * L, x_c)

    # each chunk's contribution to the state at its end
    dA_cum = torch.cumsum(dA_c, dim=-1)                          # (b,c,h,Q)
    decay_states = torch.exp(dA_cum[..., -1:] - dA_cum)          # (b,c,h,Q)
    states = torch.einsum("bcshn,bcshp->bchpn",
                          B_c * decay_states.permute(0, 1, 3, 2)[..., None],
                          x_c)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(dA_cum[..., -1])                     # (b,c,h)
    s = (torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
         if init_state is None else init_state)
    prev = []
    for ci in range(c):
        prev.append(s)
        s = s * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                       # (b,c,h,p,n)

    y_off = torch.einsum("bcqhn,bchpn->bcqhp", C_c, prev_states) \
        * torch.exp(dA_cum).permute(0, 1, 3, 2)[..., None]
    y = (y_diag + y_off).reshape(b, l, h, p) + x * D[None, None, :, None]
    return y[:, :l_orig], s


def _records_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records the SSD's inputs: the scan then runs as
    :func:`ssd_chunked`'s einsums, which it differentiates; otherwise
    (the served prefill, under ``no_grad``) as ``kernels.ops.ssd_scan``,
    the hand-written kernels on the card."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def mamba_fwd(p: Mamba, x: torch.Tensor, *, mc: MambaConfig, d_model: int,
              cache: Optional[Dict[str, torch.Tensor]] = None, tp=None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Mamba-2 block forward.

    Train/prefill: x (B, S, D), cache None -> (out, None).  With a cache
    ``{'state': (B, H, P, N), 'conv_x': (B, K-1, di), 'conv_B'/'conv_C':
    (B, K-1, gn)}``: a prefill (S > 1, zero conv state assumed, the SSM
    starting from ``state``) or one decode token; the cache is written
    in place (the SSM state cast to its dtype; a prefill keeps the last
    K-1 *pre-convolution* inputs) and returned.

    ``tp`` (``models.tp.TP``): this rank holds the JAX package's block
    ``[c0, c1) = tp.block(di)`` of the d_inner channels in ``w_z``,
    ``w_x``, ``conv_x``, ``conv_bx``, ``norm`` and the rows of
    ``out_proj`` (equal blocks: the steps refuse an M that does not
    divide d_inner), which may start or end inside a head.  It runs the
    heads the block touches, ``c0 // P`` to ``ceil(c1 / P)``: their
    columns of the ``w_dt`` product and of ``dt_bias``, ``A_log`` and
    ``D``, and each head's group of ``w_B``/``w_C``, which it holds whole
    with their convolutions.  SSD is independent per channel once a
    head's ``dt``, ``A``, ``D`` and B/C are fixed, so the channels of a
    cut head held elsewhere enter as zeros and are dropped after the
    scan: exact, and their zero inputs add nothing to any gradient.  A
    cache holds whole heads (its state is split by heads): with one,
    the block must be whole heads.  The gated norm spans the whole
    d_inner: its sums of squares are summed over the group before the
    scale.  The output is this rank's partial sum, which the caller
    reduces.
    """
    di = mc.d_inner(d_model)
    nh = mc.n_heads(d_model)
    hd = mc.head_dim
    cs = slice(0, di) if tp is None else tp.block(di)
    di_local = cs.stop - cs.start
    if p.w_x.shape[1] != di_local:
        raise ValueError(f"mamba_fwd: {p.w_x.shape[1]} channels held, the"
                         f" block of {di} is {cs}")
    hs = slice(cs.start // hd, -(-cs.stop // hd))
    lead, trail = cs.start - hs.start * hd, hs.stop * hd - cs.stop
    if cache is not None and (lead or trail):
        raise ValueError(f"mamba_fwd: a cache holds whole heads of {hd}"
                         f" channels, this rank's channels {cs} cut one")
    rep = nh // mc.n_groups
    b = x.shape[0]
    z = x @ p.w_z
    xr = x @ p.w_x
    Br = x @ p.w_B
    Cr = x @ p.w_C
    dt = F.softplus((x @ p.w_dt[:, hs]).float() + p.dt_bias[hs])
    A = -torch.exp(p.A_log[hs])
    Dh = p.D[hs]
    nh_local = hs.stop - hs.start

    if cache is None or x.shape[1] > 1:
        # the full sequence (training, or a prefill seeding a fresh
        # cache: the plain causal convolution is exact from zero state)
        xs = _causal_conv(xr, p.conv_x, p.conv_bx)
        Bm = _causal_conv(Br, p.conv_B, p.conv_bB)
        Cm = _causal_conv(Cr, p.conv_C, p.conv_bC)
        s = x.shape[1]
        Bg = Bm.reshape(b, s, mc.n_groups, mc.d_state)
        Cg = Cm.reshape(b, s, mc.n_groups, mc.d_state)
        if mc.n_groups > 1 and nh_local != nh:
            # each held head's group, the groups of a block of heads
            groups = torch.arange(hs.start, hs.stop, device=x.device) // rep
            Bg, Cg = Bg[:, :, groups], Cg[:, :, groups]
        if lead or trail:
            xs = F.pad(xs, (lead, trail))
        xh = xs.reshape(b, s, nh_local, hd)
        with telemetry.span("repro.ssd"):
            init = None if cache is None else cache["state"].float()
            if _records_grad(xh, dt, A, Bg, Cg, Dh):
                y, final = ssd_chunked(xh.float(), dt, A, Bg.float(),
                                       Cg.float(), Dh, mc.chunk,
                                       init_state=init)
            else:
                y, final = ops.ssd_scan(xh, dt, A, Bg, Cg, Dh, mc.chunk,
                                        init_state=init)
        y = y.reshape(b, s, nh_local * hd)
        if lead or trail:
            y = y[..., lead:lead + di_local]
        y = y.to(x.dtype)
        if cache is not None:
            kk = mc.d_conv - 1
            cache["state"].copy_(final)
            for name, u in (("conv_x", xr), ("conv_B", Br), ("conv_C", Cr)):
                # the last K-1 pre-activation inputs, zeros before them
                cache[name].copy_(F.pad(u, (0, 0, kk, 0))[:, -kk:, :])
    else:
        xs, conv_x = _conv_step(xr, cache["conv_x"], p.conv_x, p.conv_bx)
        Bm, conv_B = _conv_step(Br, cache["conv_B"], p.conv_B, p.conv_bB)
        Cm, conv_C = _conv_step(Cr, cache["conv_C"], p.conv_C, p.conv_bC)
        Bh = Bm.reshape(b, mc.n_groups, mc.d_state).repeat_interleave(
            rep, dim=1)[:, hs].float()                           # (B,H,N)
        Ch = Cm.reshape(b, mc.n_groups, mc.d_state).repeat_interleave(
            rep, dim=1)[:, hs].float()
        xh = xs.reshape(b, nh_local, hd).float()                 # (B,H,P)
        dt1 = dt[:, 0]                                           # (B,H)
        dA = torch.exp(dt1 * A)
        upd = torch.einsum("bhp,bhn->bhpn", xh * dt1[..., None], Bh)
        state = cache["state"].float() * dA[..., None, None] + upd
        y = torch.einsum("bhpn,bhn->bhp", state, Ch) \
            + xh * Dh[None, :, None]
        y = y.reshape(b, 1, di_local).to(x.dtype)
        cache["state"].copy_(state)
        cache["conv_x"].copy_(conv_x)
        cache["conv_B"].copy_(conv_B)
        cache["conv_C"].copy_(conv_C)

    if tp is None or tp.size == 1:
        y = rms_norm(y * silu(z), p.norm)
    else:
        y = rms_norm(y * silu(z), p.norm, sum_sq=lambda t: psum(t, tp),
                     width=di)
    return y @ p.out_proj, cache


def mamba_cache_shapes(batch: int, d_model: int, mc: MambaConfig
                       ) -> Dict[str, Tuple[int, ...]]:
    """The shapes of one layer's decode cache."""
    gn = mc.n_groups * mc.d_state
    return {"state": (batch, mc.n_heads(d_model), mc.head_dim, mc.d_state),
            "conv_x": (batch, mc.d_conv - 1, mc.d_inner(d_model)),
            "conv_B": (batch, mc.d_conv - 1, gn),
            "conv_C": (batch, mc.d_conv - 1, gn)}


def init_mamba_cache(batch: int, d_model: int, mc: MambaConfig, dtype,
                     device) -> Dict[str, torch.Tensor]:
    """One layer's zeroed decode cache in ``dtype``."""
    return {k: torch.zeros(s, dtype=dtype, device=device)
            for k, s in mamba_cache_shapes(batch, d_model, mc).items()}
