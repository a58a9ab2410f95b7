"""Plain PyTorch oracles of the port's kernels.

Counterpart of the JAX package's ``kernels/ref.py``: flash attention,
gradient-bucket pack/unpack and the blockwise int8 quantizers.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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


def bucket_pack_ref(leaves: Sequence[torch.Tensor],
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Flatten + (optionally cast) + concatenate."""
    parts = [l.reshape(-1) for l in leaves]
    if out_dtype is not None:
        parts = [p.to(out_dtype) for p in parts]
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def bucket_unpack_ref(flat: torch.Tensor, templates: Sequence[torch.Tensor]
                      ) -> List[torch.Tensor]:
    out = []
    off = 0
    for t in templates:
        n = t.numel()
        out.append(flat[off:off + n].reshape(t.shape).to(t.dtype))
        off += n
    return out


def quantize_blockwise_ref(x: torch.Tensor, block: int = 256
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat x -> (int8 values, per-block f32 scales).  len(x) % block == 0.

    Both divisions are true divisions by a tensor: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, which
    moves some scales by one ulp.  Non-finite inputs go as in JAX: a NaN
    in a block makes its scale NaN (``amax`` and ``clamp_min`` carry
    it), an infinity makes it infinite, and a NaN quotient (NaN / s,
    inf / inf) quantizes to 0, as XLA's float-to-int8 cast gives; the
    zero is set before the cast, whose result C++ leaves undefined."""
    xb = x.float().reshape(-1, block)
    d127 = torch.tensor(127.0, dtype=torch.float32, device=x.device)
    scale = xb.abs().amax(dim=1).clamp_min(1e-30) / d127
    q = torch.clamp(torch.round(xb / scale[:, None]), -127, 127)
    q = torch.nan_to_num(q, nan=0.0)
    return q.to(torch.int8).reshape(-1), scale


def dequantize_blockwise_ref(q: torch.Tensor, scale: torch.Tensor,
                             block: int = 256) -> torch.Tensor:
    qb = q.reshape(-1, block).float()
    return (qb * scale[:, None]).reshape(-1)
