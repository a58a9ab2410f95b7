"""Plain PyTorch oracles of the port's kernels.

Counterpart of the JAX package's ``kernels/ref.py``.  Only the oracle of
the flash-attention kernel is ported so far; those of bucket pack/unpack
and of the blockwise int8 quantizers follow with the training slice
(ROADMAP queue 2).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_BIG = -0.7 * torch.finfo(torch.float32).max


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None,
                        valid_len: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D).  Exact softmax attention.

    ``valid_len`` masks keys at or beyond it (keys padded to a block
    multiple); None keeps all ``Sk`` keys.  Masked entries contribute 0
    and a row with no valid key outputs 0, as in the kernel.
    """
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = h // hkv
    scale = d ** -0.5 if scale is None else scale
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    mask = cols < (sk if valid_len is None else valid_len)
    if causal:
        mask = mask & (cols <= rows)
    if window > 0:
        mask = mask & ((rows - cols) < window)
    s = torch.where(mask, s, NEG_BIG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p / l.clamp_min(1e-30), v.float())
    return out.to(q.dtype)
