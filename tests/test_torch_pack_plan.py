"""The host plan of the bucket pack/unpack kernels, on the CPU.

``kernels.bucket_pack.make_plan`` is a pure function of the segments'
(address, numel, dtype) and the bucket's dtype and address; the CUDA
kernel moves exactly what ``tile_pieces`` says for each tile (one CTA).
Checked here without a card: every bucket element is covered exactly
once over tiles, heads and tails; the 16-byte vector body appears only
where both the segment and the bucket address are 16-byte aligned, and
wherever such a start exists; buckets above the by-value capacity take
the device-table route.  A plain-torch emulation that applies the plan
with slice copies (tests only, on no path of the port) equals
``bucket_pack_plain`` / ``bucket_unpack_plain`` and the JAX package's
oracles and Pallas kernels (interpret mode) bit for bit.
"""

import itertools
import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.bucket_pack import bucket_pack as jpack
from repro.kernels.bucket_pack import bucket_unpack as junpack
from repro_torch.kernels import bucket_pack as bp

F32, BF16 = torch.float32, torch.bfloat16
ELEM = {F32: 4, BF16: 2}
PAIRS = [(F32, F32), (F32, BF16), (BF16, F32), (BF16, BF16)]
SIZES = (1, 13, 127, 128, 129)
# by-value capacities: 4 KiB of parameters (CUDA before 12.1), and 32 KiB
# (the library's)
CAP_4K, CAP_32K = 120, 1016
# tests/test_kernels.py's LEAF_SETS (as in test_torch_bucket_kernels.py)
LEAF_SETS = [
    [(4, 8), (16,), (3, 5, 7)],
    [(128,)],
    [(1,), (1,), (1,)],
    [(256, 128), (64,), (13,)],
    [(), (127,), (129,), ()],
]
NP = {F32: np.float32, BF16: ml_dtypes.bfloat16}


def _coverage(plan):
    """Per descriptor, how often each element is moved; and every vector
    piece as (descriptor, lo, hi)."""
    seen = [np.zeros(d.n, np.int64) for d in plan.descs]
    vec = []
    for tile in range(plan.n_tiles):
        for s, lo, hi, v in bp.tile_pieces(plan, tile):
            seen[s][lo:hi] += 1
            if v:
                vec.append((s, lo, hi))
    return seen, vec


def _synthetic(sizes, seg_dt, shifts, base=1 << 20):
    """(address, numel, dtype) triples 64 KiB apart, each shifted by a
    multiple of the element size."""
    return [(base + (i << 16) + sh * ELEM[seg_dt], n, seg_dt)
            for i, (n, sh) in enumerate(zip(sizes, shifts))]


@pytest.mark.parametrize("seg_dt,bucket_dt", PAIRS)
@pytest.mark.parametrize("shift", range(8))
@pytest.mark.parametrize("bucket_shift", [0, 1, 3])
def test_every_element_once_vector_only_where_aligned(seg_dt, bucket_dt,
                                                      shift, bucket_shift):
    sizes = SIZES + (4099, 70001)
    segs = _synthetic(sizes, seg_dt, [(shift + i) % 8
                                      for i in range(len(sizes))])
    b_addr = (1 << 30) + bucket_shift * ELEM[bucket_dt]
    plan = bp.make_plan(segs, bucket_dt, b_addr, CAP_32K)
    assert plan.total == sum(sizes) and plan.by_value
    seen, vec = _coverage(plan)
    assert all((c == 1).all() for c in seen)
    u = bp.vector_unit(seg_dt, bucket_dt)
    es, eb = ELEM[seg_dt], ELEM[bucket_dt]
    for s, lo, hi in vec:
        d = plan.descs[s]
        assert (hi - lo) % u == 0
        for j in range(lo, hi, u):  # every 16-byte access, both sides
            assert (d.ptr + j * es) % 16 == 0
            assert (b_addr + (d.off + j) * eb) % 16 == 0
    for d in plan.descs:
        # a body exists exactly where a common aligned start does
        start = [j for j in range(u) if j <= d.n
                 and (d.ptr + j * es) % 16 == 0
                 and (b_addr + (d.off + j) * eb) % 16 == 0]
        assert d.vec == bool(start)
        if d.vec:
            assert d.head == start[0] < u
            tail = d.n - d.head - (d.n - d.head) // u * u
            assert 0 <= tail < u


@pytest.mark.parametrize("seg_dt,bucket_dt", PAIRS)
def test_misaligned_classes_go_scalar(seg_dt, bucket_dt):
    """Addresses that differ mod 16 in a way no head can fix."""
    es, eb = ELEM[seg_dt], ELEM[bucket_dt]
    for sa, ba in itertools.product(range(0, 16, es), range(0, 16, eb)):
        vec, head = bp.alignment(4096 + sa, seg_dt, 8192 + ba, bucket_dt,
                                 1000)
        u = bp.vector_unit(seg_dt, bucket_dt)
        # the vector start j must align both: (sa + j es) and (ba + j eb)
        ok = [j for j in range(u)
              if (sa + j * es) % 16 == 0 and (ba + j * eb) % 16 == 0]
        assert vec == bool(ok) and head == (ok[0] if ok else 0)
    # f32 -> f32 at 4 and 8 mod 16: never aligned together
    assert bp.alignment(4, F32, 8, F32, 1000) == (False, 0)
    # a head longer than the segment: all scalar
    assert bp.alignment(4, F32, 4, BF16, 2) == (False, 0)


def test_tiles_hold_at_most_tile_bytes_of_body():
    segs = _synthetic((1, 70001, 4096 * 3, 4097), F32, (1, 0, 0, 0))
    plan = bp.make_plan(segs, F32, 1 << 30, CAP_32K)
    e = bp.TILE_BYTES // 4
    # seg 0 one tile; 70001 f32 at an aligned start: 17 full + 1; 3 tiles
    # of exactly 4096; 4097: 2 tiles
    assert [d.first_tile for d in plan.descs] == [0, 1, 19, 22]
    assert plan.n_tiles == 24
    for tile in range(plan.n_tiles):
        body = [hi - lo for _, lo, hi, v in bp.tile_pieces(plan, tile) if v]
        assert sum(body) <= e
        assert bp.segment_of_tile(plan, tile) == \
            max(i for i, d in enumerate(plan.descs) if d.first_tile <= tile)


def test_empty_segments_get_no_descriptor():
    segs = [(4096, 0, F32), (8192, 5, F32), (12288, 0, BF16)]
    plan = bp.make_plan(segs, F32, 1 << 20, CAP_4K)
    assert len(plan.descs) == 1 and plan.descs[0].off == 0
    assert plan.total == 5 and plan.n_tiles == 1


@pytest.mark.parametrize("seg_dt,bucket_dt", PAIRS)
def test_a_tile_holds_whole_vector_units(seg_dt, bucket_dt):
    """The tile size is the kernel's constant, and a tile's body is whole
    16-byte units of every dtype pair (else a tile's vector loop would
    skip elements or start off 16 bytes)."""
    src = (Path(bp.__file__).resolve().parent.parent / "csrc"
           / "bucket_pack.cu").read_text()
    assert int(re.search(r"kTileBytes = (\d+);", src).group(1)) \
        == bp.TILE_BYTES
    e = bp.TILE_BYTES // ELEM[bucket_dt]
    u = bp.vector_unit(seg_dt, bucket_dt)
    assert e % u == 0
    assert (e * ELEM[seg_dt]) % 16 == 0 and (e * ELEM[bucket_dt]) % 16 == 0


@pytest.mark.parametrize("k,cap,by_value", [
    (300, CAP_4K, False), (300, CAP_32K, True), (CAP_4K, CAP_4K, True),
    (CAP_4K + 1, CAP_4K, False), (CAP_32K + 1, CAP_32K, False),
    (2, CAP_4K, True), (17, CAP_4K, True)])
def test_above_capacity_takes_the_device_table(k, cap, by_value):
    """The training path's buckets (2 and 17 segments) go by value; the
    300-leaf case goes through the device table where a launch takes 4
    KiB of parameters."""
    segs = _synthetic([(7 * i) % 131 + 1 for i in range(k)], F32,
                      [0] * k)
    plan = bp.make_plan(segs, F32, 1 << 30, cap)
    assert plan.by_value == by_value
    seen, _ = _coverage(plan)
    assert all((c == 1).all() for c in seen)


@pytest.mark.parametrize("k", [2, 17, 33, CAP_32K + 1])
@pytest.mark.parametrize("pack", [True, False])
def test_parameter_block_as_the_kernel_reads_it(monkeypatch, k, pack):
    """A ready plan's parameter block: the header, then by value the
    descriptors as the plan states them, spanning what the library asks
    for K descriptors; above the capacity the header alone, the
    descriptors as table bytes."""
    class Lib:
        bucket_launch = object()
        def bucket_pack_capacity(self):
            return CAP_32K
        def bucket_pack_param_bytes(self, k):  # the library's two instances
            return 16 + 32 * (32 if k <= 32 else CAP_32K)
    monkeypatch.setattr(bp, "_library", Lib)
    buf = torch.zeros(8 * k + 64)
    segs = [buf[1 + 5 * i:1 + 5 * i + 1 + i % 3] for i in range(k)]
    bucket = torch.empty(sum(s.numel() for s in segs))
    ready = bp._ready(segs, bucket, pack)
    plan = bp.make_plan([(s.data_ptr(), s.numel(), F32) for s in segs], F32,
                        bucket.data_ptr(), CAP_32K)
    assert ready.total == plan.total and ready.device == bucket.device
    new = ready.empty(3)
    assert new.shape == (3,) and new.dtype == bucket.dtype
    assert ready.params == bp.ctypes.addressof(ready.block)
    h = bp._Header.from_buffer(ready.block)
    assert (h.K, h.n_tiles, h.bucket_dt, h.pack) == (k, plan.n_tiles, 0,
                                                     int(pack))
    if plan.by_value:
        assert ready.table is None
        assert len(ready.block) == Lib().bucket_pack_param_bytes(k)
        raw = (bp._Seg * k).from_buffer(ready.block, 16)
    else:
        assert len(ready.block) == 16
        raw = (bp._Seg * k).from_buffer(bytearray(ready.table.numpy()))
    for r, d in zip(raw, plan.descs):
        assert (r.ptr, r.off, r.n, r.first_tile, r.vec, r.head) == (
            d.ptr, d.off, d.n, d.first_tile, int(d.vec), d.head)
        assert r.dtype == bp._DTYPE_CODE[d.dtype]


# ---------------------------------------------------------------------------
# The plan applied with slice copies, against the plain versions and JAX
# ---------------------------------------------------------------------------

def _emulate_pack(segs, bucket_dt, cap=CAP_32K):
    total = sum(s.numel() for s in segs)
    out = torch.full((total,), float("nan"), dtype=bucket_dt)
    live = [s.reshape(-1) for s in segs if s.numel()]
    plan = bp.make_plan([(s.data_ptr(), s.numel(), s.dtype) for s in segs],
                        bucket_dt, out.data_ptr(), cap)
    for tile in range(plan.n_tiles):
        for s, lo, hi, _ in bp.tile_pieces(plan, tile):
            off = plan.descs[s].off
            out[off + lo:off + hi] = live[s][lo:hi].to(bucket_dt)
    return out


def _emulate_unpack(flat, templates, out=None, cap=CAP_32K):
    out = out or [torch.full_like(t, float("nan")) for t in templates]
    live = [o.view(-1) for o in out if o.numel()]
    plan = bp.make_plan([(o.data_ptr(), o.numel(), o.dtype) for o in out],
                        flat.dtype, flat.data_ptr(), cap)
    for tile in range(plan.n_tiles):
        for s, lo, hi, _ in bp.tile_pieces(plan, tile):
            off = plan.descs[s].off
            live[s][lo:hi] = flat[off + lo:off + hi].to(live[s].dtype)
    return out


def _bits(t):
    return t.view(torch.int16 if t.dtype == BF16 else torch.int32)


def _leaves(shapes, dt, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32).astype(NP[dt])
            for s in shapes]
    return arrs, [torch.from_numpy(np.asarray(a, np.float32)).to(dt)
                  for a in arrs]


@pytest.mark.parametrize("shapes", LEAF_SETS)
@pytest.mark.parametrize("seg_dt,bucket_dt", PAIRS)
def test_emulated_pack_equals_plain_and_jax(shapes, seg_dt, bucket_dt):
    arrs, ts = _leaves(shapes, seg_dt, 0)
    got = _emulate_pack(ts, bucket_dt)
    assert torch.equal(_bits(got), _bits(bp.bucket_pack_plain(ts,
                                                              bucket_dt)))
    jdt = jnp.float32 if bucket_dt == F32 else jnp.bfloat16
    want = jref.bucket_pack_ref([jnp.asarray(a) for a in arrs], jdt)
    pallas = jpack([jnp.asarray(a) for a in arrs], jdt, interpret=True)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(pallas, np.float32))


@pytest.mark.parametrize("shapes", LEAF_SETS)
@pytest.mark.parametrize("seg_dt,bucket_dt", PAIRS)
def test_emulated_unpack_equals_plain_and_jax(shapes, seg_dt, bucket_dt):
    n = sum(int(np.prod(s)) for s in shapes)
    (flat_np,), (flat,) = _leaves([(n,)], bucket_dt, 1)
    tmpl_np, tmpl = _leaves(shapes, seg_dt, 2)
    got = _emulate_unpack(flat, tmpl)
    want = jref.bucket_unpack_ref(jnp.asarray(flat_np),
                                  [jnp.asarray(a) for a in tmpl_np])
    pallas = junpack(jnp.asarray(flat_np), [jnp.asarray(a) for a in tmpl_np],
                     interpret=True)
    for g, p, w, q in zip(got, bp.bucket_unpack_plain(flat, tmpl), want,
                          pallas):
        assert torch.equal(_bits(g), _bits(p))
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(q, np.float32))


@pytest.mark.parametrize("seg_dt,bucket_dt", PAIRS)
@pytest.mark.parametrize("flat_shift", [0, 1, 3])
def test_emulation_on_views_at_odd_offsets(seg_dt, bucket_dt, flat_shift):
    """Segments, destinations and the bucket as views at odd element
    offsets: heads, tails and all-scalar segments, over several tiles."""
    sizes = SIZES + (4099, 20001)
    offs = [sum(sizes[:i]) + 16 * i + 2 * i + 1 for i in range(len(sizes))]
    _, (buf,) = _leaves([(offs[-1] + sizes[-1] + 1,)], seg_dt, 3)
    segs = [buf[o:o + n] for o, n in zip(offs, sizes)]
    flat = _emulate_pack(segs, bucket_dt)
    assert torch.equal(_bits(flat), _bits(bp.bucket_pack_plain(segs,
                                                               bucket_dt)))
    plan = bp.make_plan([(s.data_ptr(), s.numel(), s.dtype) for s in segs],
                        bucket_dt, flat.data_ptr(), CAP_32K)
    assert plan.n_tiles > len(segs)
    src = torch.empty(flat.numel() + 4, dtype=bucket_dt)[
        flat_shift:flat_shift + flat.numel()]
    src.copy_(flat)
    dst_buf = torch.full_like(buf, float("nan"))
    outs = _emulate_unpack(src, segs, [dst_buf[o:o + n]
                                       for o, n in zip(offs, sizes)])
    for o, w in zip(outs, bp.bucket_unpack_plain(src, segs)):
        assert torch.equal(_bits(o), _bits(w))
    if bucket_dt == F32:  # the round trip through f32 is exact
        assert all(torch.equal(_bits(o), _bits(s))
                   for o, s in zip(outs, segs))


def test_emulation_above_capacity_and_300_leaves():
    _, ts = _leaves([((7 * i) % 131 + 1,) for i in range(300)], F32, 4)
    plan = bp.make_plan([(t.data_ptr(), t.numel(), t.dtype) for t in ts],
                        F32, 1 << 20, CAP_4K)
    assert not plan.by_value
    flat = _emulate_pack(ts, BF16, cap=CAP_4K)
    assert torch.equal(_bits(flat), _bits(bp.bucket_pack_plain(ts, BF16)))
    back = _emulate_unpack(flat, ts, cap=CAP_4K)
    for b, w in zip(back, bp.bucket_unpack_plain(flat, ts)):
        assert torch.equal(_bits(b), _bits(w))
