"""Mixture-of-experts FFN with top-k routing, dispatched in chunks.

The port's counterpart of the JAX package's ``models/moe.py``.  Tokens
are routed in fixed-size chunks and capacity is per chunk, so the
dispatch buffers are bounded whatever the token count.  The scatter
moves token *indices*, never token vectors; the ``(E, cap, D)`` expert
batch is a gather, and the expert products are batched matrix products
(the JAX package computes them as einsums outside any Pallas kernel).
Padded experts (``n_experts_padded > n_experts``) get ``-inf`` router
logits, so routing sees the logical expert count only.

Parameters keep the JAX shapes and names: ``router`` ``(D, E)`` in f32,
``w_gate``/``w_up`` ``(E, D, F)`` and ``w_down`` ``(E, F, D)``, the
experts stacked on the leading axis.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from .. import telemetry
from ..compat import axis_index
from .layers import dense_init, silu
from .tp import gather_rows


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    n_experts_padded: int = 0     # 0 -> equal to n_experts
    capacity_factor: float = 1.25
    min_capacity: int = 4
    dispatch_chunk: int = 4096    # tokens routed per scan step

    @property
    def e_pad(self) -> int:
        return self.n_experts_padded or self.n_experts

    def capacity(self, n_tokens: int) -> int:
        cap = int(math.ceil(n_tokens * self.top_k / self.n_experts
                            * self.capacity_factor))
        return max(self.min_capacity, cap)


class MoE(nn.Module):
    """The router ``(D, E)`` (always f32, as in the JAX package) and the
    stacked SwiGLU experts, allocated uninitialised; :func:`init_moe`
    fills them."""

    def __init__(self, d_model: int, mo: MoEConfig, *, dtype, device):
        super().__init__()

        def p(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                requires_grad=False)
        e = mo.e_pad
        self.router = p(d_model, e, dt=torch.float32)
        self.w_gate = p(e, d_model, mo.d_expert)
        self.w_up = p(e, d_model, mo.d_expert)
        self.w_down = p(e, mo.d_expert, d_model)


@torch.no_grad()
def init_moe(p: MoE, gen: torch.Generator, mo: MoEConfig) -> MoE:
    """Fan-in truncated normals, drawn expert by expert; the padded
    expert slots (never routed) are zero."""
    e, d, f = p.w_gate.shape
    dt = p.w_gate.dtype
    p.router.copy_(dense_init(gen, d, (e,), torch.float32))
    for w, (i, o) in ((p.w_gate, (d, f)), (p.w_up, (d, f)),
                      (p.w_down, (f, d))):
        for j in range(e):
            w[j].copy_(dense_init(gen, i, (o,), dt))
        w[mo.n_experts:].zero_()
    return p


def router_top_k(p: MoE, xc: torch.Tensor, mo: MoEConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top-k f32 router logits, top-k expert ids) of a chunk ``xc``
    (T, D).  The router product runs in the activation dtype; the
    ranking in f32."""
    logits = (xc @ p.router.to(xc.dtype)).float()
    if mo.e_pad > mo.n_experts:  # padded experts are never routable
        logits[:, mo.n_experts:] = -torch.inf
    return torch.topk(logits, mo.top_k, dim=-1)


def _route_chunk(p: MoE, xc: torch.Tensor, mo: MoEConfig,
                 e_lo: int = 0, count: bool = True) -> torch.Tensor:
    """Route one chunk of tokens: xc (T_c, D) -> (T_c, D).  ``p`` holds
    the experts [e_lo, e_lo + its count) (all of them unsharded): every
    token is routed over all experts, and only the held experts' buffers
    are computed; the result is the sum over the slots those experts
    take, a partial sum under expert parallelism.  With ``count``, a
    profile's counters ``moe.slots`` and ``moe.dropped`` take the
    chunk's slots and those past capacity (``telemetry.count``)."""
    tc, d = xc.shape
    e, k = mo.e_pad, mo.top_k
    e_held = p.w_gate.shape[0]
    cap = mo.capacity(tc)
    with telemetry.span("repro.moe.route"):
        top_vals, top_idx = router_top_k(p, xc, mo)
        gates = torch.softmax(top_vals, dim=-1)

        # position of each (token, slot) in its expert's capacity buffer:
        # a token-major running count of the slots routed to that expert.
        # The one-hots are laid out expert-major, so the count runs along
        # rows: a scan down the columns of (T_c * k, E) runs only E wide on
        # the card, and F.one_hot checks its input's range with a host sync.
        flat_e = top_idx.reshape(-1)                       # (T_c * k,)
        onehot = (torch.arange(e, device=xc.device)[:, None]
                  == flat_e[None, :]).int()                # (E, T_c * k)
        pos = onehot.cumsum(dim=1, dtype=torch.int32) - 1
        pos = pos.gather(0, flat_e[None, :])[0].long()
        keep = pos < cap
        pos_c = torch.where(keep, pos, cap)                # overflow column

        # scatter token INDICES; the sentinel T_c gathers a zero row.  Every
        # kept (expert, position) is written once; the overflow column takes
        # duplicate writes and is sliced away.
        tok_idx = torch.arange(tc, device=xc.device).repeat_interleave(k)
        buf_idx = torch.full((e, cap + 1), tc, dtype=torch.long,
                             device=xc.device)
        buf_idx.index_put_((flat_e, pos_c), tok_idx)
        buf_idx = buf_idx[:, :cap]
        if count and telemetry.counting():
            telemetry.count("moe.slots", tc * k)
            telemetry.count("moe.dropped", (~keep).sum())

    with telemetry.span("repro.moe.experts"):
        xc_ext = torch.cat([telemetry.mark_in(xc, "repro.moe.experts"),
                            xc.new_zeros((1, d))])
        buf = xc_ext[buf_idx[e_lo:e_lo + e_held]]          # (E_h, cap, D)
        h = silu(torch.bmm(buf, p.w_gate)) * torch.bmm(buf, p.w_up)
        out = telemetry.mark_out(torch.bmm(h, p.w_down),   # (E_h, cap, D)
                                 "repro.moe.experts")

    # gather back per slot; dropped slots, and under expert parallelism
    # the slots of experts held elsewhere, are zero-weighted
    with telemetry.span("repro.moe.combine"):
        out = telemetry.mark_in(out, "repro.moe.combine")
        gates = telemetry.mark_in(gates, "repro.moe.combine")
        held = (flat_e >= e_lo) & (flat_e < e_lo + e_held)
        per_slot = out[(flat_e - e_lo).clamp(0, e_held - 1), pos_c % cap]
        w = (gates.reshape(-1) * (keep & held)).to(xc.dtype)
        y = (per_slot * w[:, None]).reshape(tc, k, d).sum(dim=1)
        return telemetry.mark_out(y, "repro.moe.combine")


def moe_fwd(p: MoE, x: torch.Tensor, *, mo: MoEConfig,
            tp=None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).  Top-k routed SwiGLU experts, the
    tokens dispatched ``dispatch_chunk`` at a time (one chunk when the
    token count is not a multiple of it).

    ``tp`` (``models.tp.TP``): expert parallel, this rank holds the
    experts [r E/M, (r+1) E/M) of ``w_gate``, ``w_up`` and ``w_down``
    and the router whole; routing, capacity and drops are the unsharded
    model's (every rank routes every token of the chunk), and the output
    is this rank's partial sum, which the caller reduces.  Where the
    data axes split the batch (``tp.rows_group``) the rows are gathered
    first and this rank's returned, so the capacity counts the whole
    chunk's tokens, as in the JAX package."""
    if tp is not None and tp.rows_group is not None:
        rows = x.shape[0]
        r = axis_index(tp.rows_group)
        out = moe_fwd(p, gather_rows(x, tp), mo=mo,
                      tp=dataclasses.replace(tp, rows_group=None))
        return out[r * rows:(r + 1) * rows]
    b, s, d = x.shape
    e_lo = 0 if tp is None else tp.rank * p.w_gate.shape[0]
    t = b * s
    xt = x.reshape(t, d)
    chunk = min(mo.dispatch_chunk, t)
    if t % chunk:
        chunk = t  # fall back to one chunk for odd token counts
    count = tp is None or tp.rank == 0   # the drops once, not M times
    out = [_route_chunk(p, xt[c:c + chunk], mo, e_lo, count)
           for c in range(0, t, chunk)]
    return torch.cat(out).reshape(b, s, d)
