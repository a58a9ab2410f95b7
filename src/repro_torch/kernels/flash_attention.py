"""Flash attention: the wrapper of the hand-written CUDA kernels in
``csrc/flash_attention.cu`` and their plain PyTorch version.

Counterpart of the JAX package's ``kernels/flash_attention.py``, whose
Pallas kernel (``_kernel``, launched by ``flash_attention``) these
kernels replace.  On the H100 the function is bound by tensor-core FLOPs
at serving shapes (a causal prefill of 1024 tokens does about 4 * S * D
/ 2 multiply-adds for every element of q it reads).  Two kernels, chosen
by dtype (:func:`kernel_variant`):

* ``wgmma`` for bf16 operands: K/V tiles staged by TMA, Q.K^T and P.V as
  ``wgmma`` products on the tensor cores, P rounded to bf16 before P.V;
* ``simt`` for operands that promote to f32: f32 FMAs on the CUDA cores
  (TF32 would break the f32 tolerance; f32 is not on the serving path).

Both mask ragged tails themselves, so the host pads nothing.  The plain
version follows the kernel it stands for: for bf16 it is the tiled
online softmax of the ``wgmma`` kernel (its key tiles, the blocks of
:func:`tile_schedule`, P rounded to bf16 tile by tile); for f32 it is the
exact oracle on operands padded to the SIMT kernel's block multiples.

:func:`flash_attention` launches a kernel for CUDA tensors only; the
public entry point that takes the plain version for CPU tensors is
``kernels.ops.flash_attention``.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import ref

# Tile sizes of the wgmma kernel (hopper::kBlockQ, Layout::BK): 128
# query rows; 128 keys up to D 128, 64 above (shared memory).
BLOCK_Q = 128
BLOCK_K = {"narrow": 128, "wide": 64}
# Block sizes of the SIMT kernel (simt::kBlockQ, simt::kBlockK).
SIMT_BLOCK_Q = SIMT_BLOCK_K = 64
MAX_HEAD_DIM = 256

# Launch counts: one per launch the wrapper makes, and nowhere else; the
# total and one per kernel.
LAUNCHES = {"flash_attention": 0, "flash_attention_wgmma": 0,
            "flash_attention_simt": 0}

_LIB = {}
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DTYPES = (torch.float32, torch.bfloat16)


def _library() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/flash_attention.cu``."""
    lib = _LIB.get("flash_attention")
    if lib is None:
        from . import build
        lib = build.load("flash_attention")
        for fn in (lib.flash_attention_f32, lib.flash_attention_bf16):
            fn.argtypes = [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _F, _F]
            fn.restype = _I
        lib.flash_attention_error_string.argtypes = [_I]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB["flash_attention"] = lib
    return lib


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                   ) -> None:
    """Shapes, dtypes and devices the kernel takes: q (B, H, Sq, D),
    k and v (B, Hkv, Sk, D) with Hkv | H, D a multiple of 8 up to 256,
    f32 or bf16, all on one device."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: need q (B, H, Sq, D) and k, v"
                         f" (B, Hkv, Sk, D), got {tuple(q.shape)},"
                         f" {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    bk, hkv, sk, dk = k.shape
    if bk != b or dk != d or hkv < 1 or h % hkv != 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k"
                         f" {tuple(k.shape)} disagree (batch, head dim, or"
                         f" Hkv not dividing H)")
    if d % 8 != 0 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} is not a multiple"
                         f" of 8 in [8, {MAX_HEAD_DIM}]")
    if sq < 1 or sk < 1:
        raise ValueError("flash_attention: empty query or key sequence")
    for t in (q, k, v):
        if t.dtype not in _DTYPES:
            raise TypeError(f"flash_attention: dtype {t.dtype} is not f32"
                            f" or bf16")
        if t.device != q.device:
            raise ValueError("flash_attention: q, k and v lie on different"
                             " devices")


def block_k(d: int) -> int:
    """Keys per tile of the wgmma kernel at head dim ``d``."""
    return BLOCK_K["narrow" if d <= 128 else "wide"]


def kernel_variant(q_dtype: torch.dtype, k_dtype: torch.dtype,
                   v_dtype: torch.dtype) -> str:
    """The kernel that operands of these dtypes launch: ``"wgmma"`` when
    all three are bf16, else ``"simt"`` (they promote to f32)."""
    if q_dtype == k_dtype == v_dtype == torch.bfloat16:
        return "wgmma"
    return "simt"


def tile_schedule(sq: int, sk: int, causal: bool, window: int,
                  block_q: int, block_k: int
                  ) -> List[List[Tuple[int, bool]]]:
    """The key blocks the wgmma kernel visits for each query block, as
    ``(key block, needs the mask)`` pairs.  Blocks wholly above the
    causal diagonal or wholly before the window are skipped (no row of
    the query block keeps a key there); the mask is needed where a block
    reaches past Sk, crosses the diagonal or reaches the window edge."""
    n_kb = -(-sk // block_k)
    out = []
    for qb in range(-(-sq // block_q)):
        q0 = qb * block_q
        q1 = q0 + block_q - 1
        begin = max(0, q0 - window + 1) // block_k if window > 0 else 0
        end = min(n_kb, q1 // block_k + 1) if causal else n_kb
        blocks = []
        for kb in range(begin, end):
            c0 = kb * block_k
            c1 = c0 + block_k - 1
            blocks.append((kb, c1 >= sk or (causal and c1 > q0)
                           or (window > 0 and q1 - c0 >= window)))
        out.append(blocks)
    return out


def _mask(rows, cols, sk, causal, window):
    keep = (cols < sk)[None, :].expand(len(rows), len(cols))
    if causal:
        keep = keep & (cols[None, :] <= rows[:, None])
    if window > 0:
        keep = keep & ((rows[:, None] - cols[None, :]) < window)
    return keep


def _plain_tiled(q, k, v, causal, window, softcap, scale):
    """The wgmma kernel's arithmetic: the blocks of :func:`tile_schedule`,
    an online softmax per key tile in f32, the mask only on the blocks
    that need it, P rounded to bf16 before P.V."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    bk = block_k(d)
    qf = q.float()
    kf = k.float().repeat_interleave(h // hkv, dim=1)
    vf = v.float().repeat_interleave(h // hkv, dim=1)
    out = torch.empty(b, h, sq, d, dtype=torch.float32, device=q.device)
    for qb, blocks in enumerate(tile_schedule(sq, sk, causal, window,
                                              BLOCK_Q, bk)):
        r0, r1 = qb * BLOCK_Q, min((qb + 1) * BLOCK_Q, sq)
        rows = torch.arange(r0, r1, device=q.device)
        m = torch.full((b, h, r1 - r0, 1), ref.NEG_BIG, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, h, r1 - r0, d, device=q.device)
        for kb, masked in blocks:
            c0, c1 = kb * bk, min((kb + 1) * bk, sk)
            s = qf[:, :, r0:r1] @ kf[:, :, c0:c1].transpose(-1, -2) * scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            if masked:
                keep = _mask(rows, torch.arange(c0, c1, device=q.device), sk,
                             causal, window)
                s = torch.where(keep, s, ref.NEG_BIG)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            if masked:
                p = torch.where(keep, p, 0.0)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = alpha * acc + p.to(torch.bfloat16).float() @ vf[:, :, c0:c1]
            m = m_new
        out[:, :, r0:r1] = acc / l.clamp_min(1e-30)
    return out.to(q.dtype)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The kernels' plain version, for the kernel that these operands
    launch: bf16 follows the wgmma kernel (:func:`_plain_tiled`); f32 is
    :func:`ref.flash_attention_ref` on q and k/v padded to the SIMT
    kernel's block multiples, the padded keys masked by the true key
    length and the padded rows cut off."""
    check_operands(q, k, v)
    sq, sk = q.shape[2], k.shape[2]
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if kernel_variant(q.dtype, k.dtype, v.dtype) == "wgmma":
        return _plain_tiled(q, k, v, causal, window, softcap, scale)
    pq, pk = (-sq) % SIMT_BLOCK_Q, (-sk) % SIMT_BLOCK_K
    out = ref.flash_attention_ref(
        F.pad(q, (0, 0, 0, pq)), F.pad(k, (0, 0, 0, pk)),
        F.pad(v, (0, 0, 0, pk)), causal=causal, window=window,
        softcap=softcap, scale=scale, valid_len=sk)
    return out[:, :, :sq]


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Launch a kernel on CUDA tensors: q (B, H, Sq, D), k and v
    (B, Hkv, Sk, D) -> (B, H, Sq, D) in q's dtype.  bf16 operands launch
    the wgmma kernel; operands of mixed dtype run in the widest of them
    on the SIMT kernel (exact: it computes in f32) and the output is
    rounded to q's dtype.  Raises for tensors that are not on a CUDA
    device and for a failed launch."""
    check_operands(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel: tensors on {q.device},"
                         f" not on a CUDA device")
    dtype = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                v.dtype)
    variant = kernel_variant(q.dtype, k.dtype, v.dtype)
    # TMA reads from 16-byte aligned bases; a fresh allocation is one
    q_, k_, v_ = (t.to(dtype).contiguous() for t in (q, k, v))
    q_, k_, v_ = (t if t.data_ptr() % 16 == 0 else t.clone()
                  for t in (q_, k_, v_))
    b, h, sq, d = q_.shape
    hkv, sk = k_.shape[1], k_.shape[2]
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q_)
    lib = _library()
    fn = (lib.flash_attention_bf16 if variant == "wgmma"
          else lib.flash_attention_f32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(stream, q_.data_ptr(), k_.data_ptr(), v_.data_ptr(),
                out.data_ptr(), b, h, hkv, sq, sk, d, int(causal),
                int(window), int(softcap is not None),
                float(softcap or 0.0), float(scale))
    LAUNCHES["flash_attention"] += 1
    LAUNCHES[f"flash_attention_{variant}"] += 1
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}"
                           f" ({msg})")
    return out.to(q.dtype)
