"""Gradient-bucket pack / unpack: the wrapper of the hand-written CUDA
kernels in ``csrc/bucket_pack.cu`` and their plain PyTorch versions.

Counterpart of the JAX package's ``kernels/bucket_pack.py``, whose Pallas
kernels (``_pack_kernel`` and ``_unpack_kernel``) these replace.  Packing
flattens a bucket's leaves, casts them to the bucket's dtype and
concatenates them; unpacking splits the bucket back and casts each piece
to its leaf's dtype.  The kernels take *segments*: any list of contiguous
f32 or bf16 tensors, in bucket order.  A leaf that the JAX package stacks
on a leading layer axis is passed as one segment per layer, layer 0
first, which is exactly how the stacked leaf ravels, so the bucket holds
the same elements as JAX's.  The Pallas kernel's 128-lane padding is a
TPU layout and is not reproduced: its output compacts it away.

:func:`bucket_pack` and :func:`bucket_unpack` launch the kernels for CUDA
tensors only; the public entry points that take the plain versions for
CPU tensors are ``kernels.ops.bucket_pack`` / ``bucket_unpack``.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from . import ref

# Launch counts: one per launch the wrappers make, and nowhere else.
LAUNCHES = {"bucket_pack": 0, "bucket_unpack": 0}

_LIB = {}
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/bucket_pack.cu``."""
    lib = _LIB.get("bucket_pack")
    if lib is None:
        from . import build
        lib = build.load("bucket_pack")
        lib.bucket_pack.argtypes = [_VP, _VP, _I, _LL, _VP, _LL]
        lib.bucket_unpack.argtypes = [_VP, _VP, _I, _LL, _VP, _LL]
        lib.bucket_pack.restype = lib.bucket_unpack.restype = _I
        lib.bucket_pack_error_string.argtypes = [_I]
        lib.bucket_pack_error_string.restype = ctypes.c_char_p
        _LIB["bucket_pack"] = lib
    return lib


def _check(tensors: Sequence[torch.Tensor], what: str) -> None:
    if not tensors:
        raise ValueError(f"{what}: no segments")
    dev = tensors[0].device
    for t in tensors:
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{what}: dtype {t.dtype} is not f32 or bf16")
        if t.device != dev:
            raise ValueError(f"{what}: segments lie on different devices")


def bucket_pack_plain(segments: Sequence[torch.Tensor],
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """The pack kernel's plain version: :func:`ref.bucket_pack_ref` with
    the kernel's default dtype (the first segment's)."""
    _check(segments, "bucket_pack")
    return ref.bucket_pack_ref(segments, out_dtype or segments[0].dtype)


def bucket_unpack_plain(flat: torch.Tensor,
                        templates: Sequence[torch.Tensor],
                        out: Optional[Sequence[torch.Tensor]] = None
                        ) -> List[torch.Tensor]:
    """The unpack kernel's plain version: :func:`ref.bucket_unpack_ref`,
    copied into ``out`` when given."""
    _check([flat, *templates], "bucket_unpack")
    _check_sizes(flat, templates)
    pieces = ref.bucket_unpack_ref(flat, templates)
    if out is None:
        return pieces
    for o, p in zip(out, pieces):
        o.copy_(p)
    return list(out)


def _check_sizes(flat: torch.Tensor, segs: Sequence[torch.Tensor]) -> None:
    if flat.dim() != 1 or flat.numel() != sum(s.numel() for s in segs):
        raise ValueError(f"bucket_unpack: flat {tuple(flat.shape)} is not a"
                         f" vector of {sum(s.numel() for s in segs)}"
                         f" elements")


def _table(segs: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The kernel's segment table on ``device``: pointers, the prefix sum
    of the sizes, dtype codes (int64).  It is staged in pinned memory
    and copied on the current stream without waiting for it, so a pack
    inside backward does not stall the host (PyTorch's pinned-memory
    cache keeps the staging buffer until the copy has run)."""
    offs = [0]
    for s in segs:
        offs.append(offs[-1] + s.numel())
    vals = ([s.data_ptr() for s in segs] + offs
            + [_DTYPE_CODE[s.dtype] for s in segs])
    host = torch.tensor(vals, dtype=torch.int64).pin_memory()
    return host.to(device, non_blocking=True)


def _on_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} kernel: tensors on {t.device}, not on a"
                         f" CUDA device")


def _raise_if(rc: int, lib, what: str) -> None:
    if rc != 0:
        msg = lib.bucket_pack_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def bucket_pack(segments: Sequence[torch.Tensor],
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch the pack kernel on CUDA tensors: the segments flattened,
    cast to ``out_dtype`` (default: the first segment's) and
    concatenated into one new flat tensor.  Raises for tensors that are
    not on a CUDA device and for a failed launch."""
    _check(segments, "bucket_pack")
    _on_cuda(segments[0], "bucket_pack")
    out_dtype = out_dtype or segments[0].dtype
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"bucket_pack: out dtype {out_dtype} is not f32 or"
                        f" bf16")
    segs = [s.contiguous() for s in segments]
    dev = segs[0].device
    total = sum(s.numel() for s in segs)
    out = torch.empty(total, dtype=out_dtype, device=dev)
    if total == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        table = _table(segs, dev)
        rc = lib.bucket_pack(torch.cuda.current_stream(dev).cuda_stream,
                             table.data_ptr(), len(segs), total,
                             out.data_ptr(), _DTYPE_CODE[out_dtype])
    LAUNCHES["bucket_pack"] += 1
    _raise_if(rc, lib, "bucket_pack")
    return out


def bucket_unpack(flat: torch.Tensor, templates: Sequence[torch.Tensor],
                  out: Optional[Sequence[torch.Tensor]] = None
                  ) -> List[torch.Tensor]:
    """Launch the unpack kernel on CUDA tensors: ``flat`` split into
    pieces shaped and typed like ``templates``.  With ``out`` (contiguous
    tensors shaped like the templates) the pieces are written there in
    place and ``out`` is returned; otherwise new tensors are.  Raises
    for tensors that are not on a CUDA device and for a failed launch."""
    _check([flat, *templates], "bucket_unpack")
    _on_cuda(flat, "bucket_unpack")
    _check_sizes(flat, templates)
    if out is None:
        out = [torch.empty_like(t, memory_format=torch.contiguous_format)
               for t in templates]
    else:
        out = list(out)
        if len(out) != len(templates) or any(
                o.shape != t.shape or o.dtype != t.dtype
                or not o.is_contiguous() or o.device != flat.device
                for o, t in zip(out, templates)):
            raise ValueError("bucket_unpack: out must be contiguous tensors"
                             " shaped and typed like the templates, on the"
                             " bucket's device")
    total = flat.numel()
    if total == 0:
        return out
    flat = flat.contiguous()
    dev = flat.device
    lib = _library()
    with torch.cuda.device(dev):
        table = _table(out, dev)
        rc = lib.bucket_unpack(torch.cuda.current_stream(dev).cuda_stream,
                               table.data_ptr(), len(out), total,
                               flat.data_ptr(), _DTYPE_CODE[flat.dtype])
    LAUNCHES["bucket_unpack"] += 1
    _raise_if(rc, lib, "bucket_unpack")
    return out
