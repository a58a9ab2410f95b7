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

A launch follows a *plan* (:func:`make_plan`), a pure function of the
segments' (address, numel, dtype) and the bucket's dtype and address:
one descriptor per non-empty segment with its bucket offset, the index
of its first tile of ``TILE_BYTES`` bucket bytes, and its alignment
class (a scalar head up to the first element where both the segment and
the bucket are 16-byte aligned, a body of 16-byte vectors, a scalar
tail; or all scalar where the two addresses differ mod 16).
:func:`tile_pieces` states which elements one tile (one CTA) moves.
The wrappers build each plan's kernel parameter block once and cache it
by the plan's inputs, so a bucket packed every step costs one
dictionary lookup and one launch of four arguments; the descriptors go
to the kernel by value, as a launch parameter, up to the library's
capacity, and as a device table staged per call above it (``ROUTES``
counts which).

:func:`bucket_pack` and :func:`bucket_unpack` launch the kernels for CUDA
tensors only; the public entry points that take the plain versions for
CPU tensors are ``kernels.ops.bucket_pack`` / ``bucket_unpack``.
"""

from __future__ import annotations

import bisect
import ctypes
import operator
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import launch, ref

# Launch counts: one per launch the wrappers make, and nowhere else.
LAUNCHES = {"bucket_pack": 0, "bucket_unpack": 0}
# How each launch took its descriptors: as a kernel parameter, or from a
# device table staged for buckets above the by-value capacity.
ROUTES = {"by_value": 0, "table": 0}

# Bucket bytes per tile: the kernel's kTileBytes, checked at binding.
TILE_BYTES = 16384

_LIB = {}
_VP, _I = ctypes.c_void_p, ctypes.c_int
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


class _Header(ctypes.Structure):
    """What a launch needs besides the descriptors (``Header``)."""
    _fields_ = [("K", _I), ("n_tiles", _I), ("bucket_dt", _I), ("pack", _I)]


class _Seg(ctypes.Structure):
    """The kernel's descriptor of one segment (``Seg`` in the source)."""
    _fields_ = [("ptr", ctypes.c_longlong), ("off", ctypes.c_longlong),
                ("n", ctypes.c_longlong), ("first_tile", _I),
                ("dtype", ctypes.c_ubyte), ("vec", ctypes.c_ubyte),
                ("head", ctypes.c_ubyte), ("pad", ctypes.c_ubyte)]


def _library() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/bucket_pack.cu``."""
    lib = _LIB.get("bucket_pack")
    if lib is None:
        from . import build
        lib = build.load("bucket_pack")
        lib.bucket_launch.argtypes = [_VP, _VP, _VP, _VP]
        lib.bucket_launch.restype = _I
        lib.bucket_pack_param_bytes.argtypes = [_I]
        for fn in (lib.bucket_pack_param_bytes, lib.bucket_pack_capacity,
                   lib.bucket_pack_tile_bytes, lib.bucket_pack_desc_bytes):
            fn.restype = _I
        lib.bucket_pack_error_string.argtypes = [_I]
        lib.bucket_pack_error_string.restype = ctypes.c_char_p
        for what, theirs, ours in (
                ("descriptor", lib.bucket_pack_desc_bytes(),
                 ctypes.sizeof(_Seg)),
                ("tile", lib.bucket_pack_tile_bytes(), TILE_BYTES)):
            if theirs != ours:
                raise RuntimeError(f"bucket_pack: the library's {what} is"
                                   f" {theirs} bytes, the wrapper's {ours}")
        _LIB["bucket_pack"] = lib
    return lib


def capacity() -> int:
    """The most segments a launch takes by value (the library's)."""
    return _library().bucket_pack_capacity()


# ---------------------------------------------------------------------------
# The plan: pure Python, no card needed
# ---------------------------------------------------------------------------

class Desc(NamedTuple):
    """One non-empty segment as the kernel sees it."""
    ptr: int          # segment address
    off: int          # first bucket element
    n: int            # elements
    dtype: torch.dtype
    first_tile: int
    vec: bool         # head, 16-byte body, tail (else all scalar)
    head: int         # scalar elements before the body (vec only)


class PackPlan(NamedTuple):
    descs: Tuple[Desc, ...]
    bucket_dtype: torch.dtype
    n_tiles: int
    total: int        # bucket elements
    by_value: bool    # descriptors as a launch parameter


def vector_unit(seg_dtype: torch.dtype, bucket_dtype: torch.dtype) -> int:
    """Elements per 16-byte access: 4 f32, else 8 (one 16-byte bf16
    vector, against two float4 where the other side is f32)."""
    return 4 if seg_dtype == bucket_dtype == torch.float32 else 8


def alignment(seg_addr: int, seg_dtype: torch.dtype, bucket_addr: int,
              bucket_dtype: torch.dtype, n: int) -> Tuple[bool, int]:
    """(vec, head) of a segment of ``n`` elements at ``seg_addr`` whose
    first bucket element is at ``bucket_addr``: the first element where
    both addresses are 16-byte aligned, if there is one within the
    segment; else all scalar."""
    es, eb = _ELEM_BYTES[seg_dtype], _ELEM_BYTES[bucket_dtype]
    for j in range(vector_unit(seg_dtype, bucket_dtype)):
        if (seg_addr + j * es) % 16 == 0 and (bucket_addr + j * eb) % 16 == 0:
            return (True, j) if j <= n else (False, 0)
    return False, 0


def _body(d: Desc, bucket_dtype: torch.dtype) -> int:
    if not d.vec:
        return d.n
    u = vector_unit(d.dtype, bucket_dtype)
    return (d.n - d.head) // u * u


def _tiles(body: int, tile_elems: int) -> int:
    return max(1, -(-body // tile_elems))


def make_plan(segments: Sequence[Tuple[int, int, torch.dtype]],
              bucket_dtype: torch.dtype, bucket_addr: int,
              capacity: int) -> PackPlan:
    """The launch plan of a bucket at ``bucket_addr`` in ``bucket_dtype``
    over ``segments``, (address, numel, dtype) triples in bucket order.
    Empty segments get no descriptor; buckets of more than ``capacity``
    non-empty segments take the device-table route."""
    eb = _ELEM_BYTES[bucket_dtype]
    tile_elems = TILE_BYTES // eb
    descs, off, tile = [], 0, 0
    for addr, n, dt in segments:
        if n:
            vec, head = alignment(addr, dt, bucket_addr + off * eb,
                                  bucket_dtype, n)
            d = Desc(addr, off, n, dt, tile, vec, head)
            descs.append(d)
            tile += _tiles(_body(d, bucket_dtype), tile_elems)
        off += n
    return PackPlan(tuple(descs), bucket_dtype, tile, off,
                    len(descs) <= capacity)


def segment_of_tile(plan: PackPlan, tile: int) -> int:
    """The descriptor whose tiles hold ``tile``: the last one whose first
    tile is at or before it (the kernel's search)."""
    return bisect.bisect_right([d.first_tile for d in plan.descs], tile) - 1


def tile_pieces(plan: PackPlan, tile: int) -> List[Tuple[int, int, int, bool]]:
    """What the CTA of ``tile`` moves: (descriptor, lo, hi, vector)
    element ranges of one segment.  Tile t of a segment covers its body
    [head + t*E, head + (t+1)*E), clipped to the body (E = TILE_BYTES
    over the bucket's element size; 16-byte vectors where the segment
    has a body, else scalar); tile 0 also the head, the segment's last
    tile also the tail."""
    s = segment_of_tile(plan, tile)
    d = plan.descs[s]
    e = TILE_BYTES // _ELEM_BYTES[plan.bucket_dtype]
    head = d.head if d.vec else 0
    body = _body(d, plan.bucket_dtype)
    t = tile - d.first_tile
    lo, hi = head + t * e, min(head + (t + 1) * e, head + body)
    out = [(s, lo, hi, d.vec)] if lo < hi else []
    if t == 0 and head:
        out.append((s, 0, head, False))
    if t == _tiles(body, e) - 1 and head + body < d.n:
        out.append((s, head + body, d.n, False))
    return out


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# The kernel wrappers
# ---------------------------------------------------------------------------

class _Ready(NamedTuple):
    """A plan made ready to launch."""
    total: int                # bucket elements
    empty: object             # empty(n): a new bucket of n elements
    device: torch.device
    index: int                # device index
    launch: object            # the library's bucket_launch
    params: int               # address of the parameter block
    table: Optional[torch.Tensor]  # descriptor bytes (table route only)
    block: ctypes.Array       # the parameter block, kept alive


# Ready plans by their inputs, one dict per direction.  A pack key holds
# the bucket dtype, the device index and every segment's address, size
# and dtype (the bucket is a fresh allocation, 16-byte aligned); an
# unpack key the bucket's dtype, device, address mod 16, size and rank
# and the same of every destination.  An entry is made only after the
# full checks, and under unified addressing an address names its device,
# so a hit needs no per-segment check but contiguity.
_PACK_PLANS: Dict[tuple, _Ready] = {}
_UNPACK_PLANS: Dict[tuple, _Ready] = {}
_PLANS_MAX = 1024
_T = torch.Tensor
_DTYPE = operator.attrgetter("dtype")
_SHAPE = operator.attrgetter("shape")


def _ready(segs: Sequence[torch.Tensor], bucket: torch.Tensor,
           pack: bool) -> _Ready:
    """Plan ``segs`` against ``bucket`` and build the plan's parameter
    block: a header and, by value, its descriptors."""
    lib = _library()
    plan = make_plan([(s.data_ptr(), s.numel(), s.dtype) for s in segs],
                     bucket.dtype, bucket.data_ptr(),
                     lib.bucket_pack_capacity())
    k = len(plan.descs)
    descs = (_Seg * k)(*[
        _Seg(d.ptr, d.off, d.n, d.first_tile, _DTYPE_CODE[d.dtype],
             int(d.vec), d.head, 0) for d in plan.descs])
    header = _Header(k, plan.n_tiles, _DTYPE_CODE[bucket.dtype], int(pack))
    hb = ctypes.sizeof(_Header)
    block = (ctypes.c_char * (lib.bucket_pack_param_bytes(k)
                              if plan.by_value else hb))()
    ctypes.memmove(block, ctypes.byref(header), hb)
    table = None
    if plan.by_value:
        ctypes.memmove(ctypes.addressof(block) + hb, descs,
                       ctypes.sizeof(descs))
    else:
        table = torch.frombuffer(bytearray(descs), dtype=torch.uint8)
    return _Ready(plan.total, bucket.new_empty(0).new_empty, bucket.device,
                  bucket.device.index,
                  lib.bucket_launch, ctypes.addressof(block), table, block)


def _keep(plans: Dict[tuple, _Ready], key: tuple, ready: _Ready) -> None:
    if len(plans) >= _PLANS_MAX:
        plans.clear()
    plans[key] = ready


def _go(stream: int, ready: _Ready, bucket: int) -> int:
    """:func:`_run`'s launch on ``stream``, its route counted."""
    if ready.table is None:
        ROUTES["by_value"] += 1
        return ready.launch(ready.params, None, stream, bucket)
    table = ready.table.pin_memory().to(ready.device, non_blocking=True)
    ROUTES["table"] += 1
    return ready.launch(ready.params, table.data_ptr(), stream, bucket)


def _run(ready: _Ready, bucket: int, what: str) -> None:
    """One launch of a ready plan on the current stream of its device.
    Above the by-value capacity the descriptors are staged in pinned
    memory and copied to the card without a host wait (PyTorch's
    pinned-memory cache keeps the staging buffer until the copy ran)."""
    rc = launch.on_stream(ready.index, _go, ready, bucket)
    LAUNCHES[what] += 1
    if rc != 0:
        msg = _library().bucket_pack_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _on_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} kernel: tensors on {t.device}, not on a"
                         f" CUDA device")


def bucket_pack(segments: Sequence[torch.Tensor],
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch the pack kernel on CUDA tensors: the segments flattened,
    cast to ``out_dtype`` (default: the first segment's) and
    concatenated into one new flat tensor.  Raises for tensors that are
    not on a CUDA device and for a failed launch."""
    if not segments:
        raise ValueError("bucket_pack: no segments")
    out_dtype = out_dtype or segments[0].dtype
    key = (out_dtype, segments[0].get_device(),
           *map(_T.data_ptr, segments), *map(_T.numel, segments),
           *map(_DTYPE, segments))
    ready = _PACK_PLANS.get(key)
    if ready is not None and all(map(_T.is_contiguous, segments)):
        out = ready.empty(ready.total)
        bucket = out.data_ptr()
        if not bucket & 15:  # as planned
            _run(ready, bucket, "bucket_pack")
            return out
    # first sight of these inputs (or an unaligned bucket): the full checks
    _check(segments, "bucket_pack")
    _on_cuda(segments[0], "bucket_pack")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"bucket_pack: out dtype {out_dtype} is not f32 or"
                        f" bf16")
    contiguous = all(map(_T.is_contiguous, segments))
    segs = segments if contiguous else [s.contiguous() for s in segments]
    out = torch.empty(sum(map(_T.numel, segs)), dtype=out_dtype,
                      device=segs[0].device)
    if not out.numel():
        return out
    ready = _ready(segs, out, pack=True)
    if contiguous and not out.data_ptr() & 15:
        _keep(_PACK_PLANS, key, ready)
    _run(ready, out.data_ptr(), "bucket_pack")
    return out


def _like(out: Sequence[torch.Tensor],
          templates: Sequence[torch.Tensor]) -> bool:
    """``out`` is shaped and typed like ``templates``."""
    return len(out) == len(templates) and (
        all(map(operator.is_, out, templates))
        or (list(map(_SHAPE, out)) == list(map(_SHAPE, templates))
            and list(map(_DTYPE, out)) == list(map(_DTYPE, templates))))


def bucket_unpack(flat: torch.Tensor, templates: Sequence[torch.Tensor],
                  out: Optional[Sequence[torch.Tensor]] = None
                  ) -> List[torch.Tensor]:
    """Launch the unpack kernel on CUDA tensors: ``flat`` split into
    pieces shaped and typed like ``templates``.  With ``out`` (contiguous
    tensors shaped like the templates) the pieces are written there in
    place and ``out`` is returned; otherwise new tensors are.  Raises
    for tensors that are not on a CUDA device and for a failed launch."""
    if out is not None:
        key = (flat.dtype, flat.get_device(), flat.data_ptr() & 15,
               flat.numel(), flat.dim(), *map(_T.data_ptr, out),
               *map(_T.numel, out), *map(_DTYPE, out))
        ready = _UNPACK_PLANS.get(key)
        if (ready is not None and flat.is_contiguous()
                and all(map(_T.is_contiguous, out)) and _like(out, templates)):
            _run(ready, flat.data_ptr(), "bucket_unpack")
            return list(out)
    # first sight of these inputs: the full checks
    _check([flat, *templates], "bucket_unpack")
    _on_cuda(flat, "bucket_unpack")
    _check_sizes(flat, templates)
    if out is None:
        out = [torch.empty_like(t, memory_format=torch.contiguous_format)
               for t in templates]
        key = None
    elif (not all(map(_T.is_contiguous, out)) or not _like(out, templates)
          or any(o.device != flat.device for o in out)):
        raise ValueError("bucket_unpack: out must be contiguous tensors"
                         " shaped and typed like the templates, on the"
                         " bucket's device")
    out = list(out)
    if not flat.numel():
        return out
    if not flat.is_contiguous():
        flat, key = flat.contiguous(), None
    ready = _ready(out, flat, pack=False)
    if key is not None:
        _keep(_UNPACK_PLANS, key, ready)
    _run(ready, flat.data_ptr(), "bucket_unpack")
    return out
