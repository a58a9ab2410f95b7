"""Blockwise int8 quantization: the port's plain versions against JAX.

``quantize_blockwise_plain`` / ``dequantize_blockwise_plain`` (taken by
the ``ops`` entry points for CPU tensors; the CUDA kernels are held to
them bit for bit on the card) must equal the JAX package's eager oracles
``quantize_blockwise_ref`` / ``dequantize_blockwise_ref`` bit for bit in
the int8 values, the scales and the dequantized values.

Against the Pallas kernels in interpret mode the int8 values are exact,
but the scales are held only to ``rtol=1e-6``, as the JAX package's own
test holds them (``tests/test_kernels.py``): the jitted Pallas kernel
computes ``max / 127`` as ``max * float32(1/127)``, which differs from
the true division in the last bit for some blocks.  The values agree
because a one-ulp change of the scale moves ``x / scale`` by far less
than the distance to a rounding boundary on these inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.quant8 import dequantize_blockwise as jdequant
from repro.kernels.quant8 import quantize_blockwise as jquant
from repro_torch.kernels import ops
from repro_torch.kernels import quant8 as pq8

BLOCK = 256


def _heavy(n, seed, scale=1.0):
    """Heavy-tailed normals: many distinct block maxima."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * np.exp(rng.standard_normal(n))
    return (x * scale).astype(np.float32)


def _pad(x):
    return np.pad(x, (0, (-len(x)) % BLOCK))


@pytest.mark.parametrize("n", [BLOCK, 4 * BLOCK, 64 * BLOCK, 1000 * BLOCK])
@pytest.mark.parametrize("scale", [1e-6, 1.0, 1e4])
def test_plain_equals_eager_reference_bitwise(n, scale):
    x = _heavy(n, n, scale)
    q, s = pq8.quantize_blockwise_plain(torch.from_numpy(x))
    qr, sr = jref.quantize_blockwise_ref(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(sr).view(np.int32))
    y = pq8.dequantize_blockwise_plain(q, s)
    yr = jref.dequantize_blockwise_ref(qr, sr)
    np.testing.assert_array_equal(y.numpy().view(np.int32),
                                  np.asarray(yr).view(np.int32))


@pytest.mark.parametrize("n", [1, 255, 257, 64 * BLOCK + 100])
def test_ragged_tail_is_zero_padded(n):
    x = _heavy(n, 7)
    q, s = ops.quantize_blockwise(torch.from_numpy(x))
    assert q.shape == (n,) and q.dtype == torch.int8
    assert s.shape == (-(-n // BLOCK),) and s.dtype == torch.float32
    qr, sr = jref.quantize_blockwise_ref(jnp.asarray(_pad(x)))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr)[:n])
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
    y = ops.dequantize_blockwise(q, s)
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jref.dequantize_blockwise_ref(qr, sr))[:n])


@pytest.mark.parametrize("n", [BLOCK, 4 * BLOCK, 64 * BLOCK, 200 * BLOCK,
                               64 * BLOCK + 100])
def test_plain_against_pallas_interpret(n):
    x = _heavy(n, 11)
    q, s = pq8.quantize_blockwise_plain(torch.from_numpy(x))
    qp, sp = jquant(jnp.asarray(x), interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qp))
    np.testing.assert_allclose(s.numpy(), np.asarray(sp), rtol=1e-6)
    y = pq8.dequantize_blockwise_plain(q, s)
    yp = jdequant(qp, sp, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), rtol=1e-6)


def test_ties_round_half_to_even_and_zero_block():
    """A block whose max is 127/64 has scale 1/64 exactly, so (k + 1/2)
    / 64 quantizes to a tie; a block of zeros keeps the 1e-30 floor."""
    k = np.arange(-126, 126)
    tie = np.concatenate([[127.0], (k + 0.5), [-3.0, 1.0, 2.0]]) / 64.0
    x = np.concatenate([tie.astype(np.float32), np.zeros(BLOCK, np.float32)])
    q, s = ops.quantize_blockwise(torch.from_numpy(x))
    assert s[0].item() == 1.0 / 64.0
    np.testing.assert_array_equal(q.numpy()[1:253], np.round(k + 0.5))
    assert set((q.numpy()[1:253] % 2).tolist()) == {0}
    assert s[1].item() == np.float32(np.float32(1e-30) / np.float32(127.0))
    assert not q.numpy()[BLOCK:].any()
    qr, sr = jref.quantize_blockwise_ref(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))


@pytest.mark.parametrize("scale", [1e-6, 1.0, 1e4])
def test_round_trip_error_bound(scale):
    """|dequant(quant(x)) - x| <= scale / 2 per block."""
    x = _heavy(4 * BLOCK + 17, 3, scale)
    q, s = ops.quantize_blockwise(torch.from_numpy(x))
    back = ops.dequantize_blockwise(q, s).numpy()
    bound = np.repeat(s.numpy() * 0.5, BLOCK)[:len(x)]
    assert (np.abs(back - x) <= bound * 1.001 + 1e-30).all()


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_operands():
    x = torch.ones(300)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        pq8.quantize_blockwise(x)
    q, s = ops.quantize_blockwise(x)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        pq8.dequantize_blockwise(q, s)
    with pytest.raises(ValueError, match="flat vector"):
        ops.quantize_blockwise(torch.ones(2, 3))
    with pytest.raises(ValueError, match="2 f32 scales"):
        ops.dequantize_blockwise(q, s[:1])
    assert pq8.LAUNCHES == {"quantize_blockwise": 0,
                            "dequantize_blockwise": 0}


# ---------------------------------------------------------------------------
# Non-finite inputs: a NaN makes its block's scale NaN, an infinity makes
# it infinite, and a NaN quotient (NaN / s, inf / inf) quantizes to 0, in
# JAX's eager reference, its Pallas kernel and the port alike.

def _nonfinite(n, seed):
    """Heavy-tailed normals with a NaN in block 0, +inf in block 1, -inf in
    block 2, NaN and +inf in block 3, and a NaN as the last element (in a
    ragged tail when n % 256)."""
    x = _heavy(n, seed)
    x[3] = np.nan
    x[BLOCK + 7] = np.inf
    x[2 * BLOCK + 200] = -np.inf
    x[3 * BLOCK + 5], x[3 * BLOCK + 9] = np.nan, np.inf
    x[-1] = np.nan
    return x


def _bits32(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("n", [5 * BLOCK, 4 * BLOCK + 1, 8 * BLOCK + 100])
def test_nonfinite_plain_equals_eager_reference_bitwise(n):
    x = _nonfinite(n, n)
    q, s = pq8.quantize_blockwise_plain(torch.from_numpy(x))
    qr, sr = jref.quantize_blockwise_ref(jnp.asarray(_pad(x)))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr)[:n])
    np.testing.assert_array_equal(_bits32(s), _bits32(sr))
    y = pq8.dequantize_blockwise_plain(q, s)
    yr = jref.dequantize_blockwise_ref(qr, sr)
    np.testing.assert_array_equal(_bits32(y), _bits32(yr)[:n])
    # what JAX gives, spelled out
    sn = s.numpy()
    assert np.isnan(sn[[0, 3, -1]]).all()
    assert np.isposinf(sn[[1, 2]]).all()
    assert not q.numpy()[:4 * BLOCK].any()
    assert np.isnan(y.numpy()[:4 * BLOCK]).all()  # NaN * q, 0 * inf
    assert not q.numpy()[(n - 1) // BLOCK * BLOCK:].any()


@pytest.mark.parametrize("n", [8 * BLOCK, 4 * BLOCK + 1, 64 * BLOCK + 100])
def test_nonfinite_plain_against_pallas_interpret(n):
    """Values exact; the scales NaN and infinite at the same blocks, the
    finite ones within rtol=1e-6 (the kernel's ``* (1/127)``)."""
    x = _nonfinite(n, n + 1)
    q, s = pq8.quantize_blockwise_plain(torch.from_numpy(x))
    qp, sp = jquant(jnp.asarray(x), interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qp))
    sn, spn = s.numpy(), np.asarray(sp)
    np.testing.assert_array_equal(np.isnan(sn), np.isnan(spn))
    np.testing.assert_array_equal(np.isposinf(sn), np.isposinf(spn))
    np.testing.assert_allclose(sn, spn, rtol=1e-6)  # NaNs compare equal
    y = pq8.dequantize_blockwise_plain(q, s)
    yp = jdequant(qp, sp, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), rtol=1e-6)


# ---------------------------------------------------------------------------
# bf16 inputs, widened to f32 before the block max as the Pallas kernel's
# astype does.

def _bf16(x):
    """The same bf16 values for JAX and the port (both round to nearest
    even from f32)."""
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(xj).view(np.uint16),
                                  xt.view(torch.int16).numpy()
                                  .view(np.uint16))
    return xj, xt


@pytest.mark.parametrize("n", [BLOCK, 64 * BLOCK + 100, 200 * BLOCK])
def test_bf16_plain_equals_eager_reference_bitwise(n):
    xj, xt = _bf16(_heavy(n, 0))
    q, s = ops.quantize_blockwise(xt)
    qr, sr = jref.quantize_blockwise_ref(jnp.pad(xj, (0, (-n) % BLOCK)))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr)[:n])
    np.testing.assert_array_equal(_bits32(s), _bits32(sr))


@pytest.mark.parametrize("n", [BLOCK, 64 * BLOCK + 100, 200 * BLOCK])
def test_bf16_plain_against_pallas_interpret(n):
    """Scales within rtol=1e-6; int8 values equal but where the Pallas
    kernel's ``* (1/127)`` scale, one ulp off the true quotient's, moves a
    tie by one -- and there the port equals the eager reference.  At n =
    64 * 256 + 100 that is one value of 16 484 (-64 against -63)."""
    xj, xt = _bf16(_heavy(n, 0))
    q, s = pq8.quantize_blockwise_plain(xt)
    qp, sp = jquant(xj, interpret=True)
    qr, sr = jref.quantize_blockwise_ref(jnp.pad(xj, (0, (-n) % BLOCK)))
    np.testing.assert_allclose(s.numpy(), np.asarray(sp), rtol=1e-6)
    qn, qpn = q.numpy(), np.asarray(qp)
    moved = np.nonzero(qn != qpn)[0]
    assert len(moved) <= max(1, n // 10000)
    np.testing.assert_array_equal(np.abs(qn[moved].astype(int)
                                         - qpn[moved].astype(int)), 1)
    blocks = moved // BLOCK
    assert (_bits32(sp)[blocks] != _bits32(sr)[blocks]).all()
    np.testing.assert_array_equal(qn[moved], np.asarray(qr)[moved])


# ---------------------------------------------------------------------------
# The host's route: 16-byte accesses for aligned bf16 or int8 data,
# scalar for f32 (whose 4-byte loads already fill whole sectors) and for
# a view at an odd element offset.  CPU allocations are 64-byte aligned.

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 64 * BLOCK + 100])
def test_route_vec_for_aligned_scalar_for_odd_offsets(dtype, n):
    buf = torch.zeros(n + 64, dtype=dtype)
    per16 = 16 // buf.element_size()
    assert buf.data_ptr() % 64 == 0
    aligned = "scalar" if dtype == torch.float32 else "vec"
    assert pq8.route(buf[:n]) == aligned
    assert pq8.route(buf[per16:per16 + n]) == aligned
    for off in (1, 3, per16 - 1, per16 + 1):
        if off % per16:
            assert pq8.route(buf[off:off + n]) == "scalar"
    assert pq8.LAUNCHES == {"quantize_blockwise": 0,
                            "dequantize_blockwise": 0}
    assert pq8.ROUTES == {"vec": 0, "scalar": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("off", [1, 3])
def test_odd_offset_views_equal_eager_reference(dtype, off):
    n = 4 * BLOCK + 17
    x = _nonfinite(n + off, 5)
    if dtype == torch.bfloat16:  # JAX's rounding, and its NaN (0x7fc0)
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.int16)
    x = torch.from_numpy(x.copy()).view(dtype)[off:]
    q, s = ops.quantize_blockwise(x)
    qr, sr = jref.quantize_blockwise_ref(
        jnp.asarray(_pad(x.float().numpy())))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr)[:n])
    np.testing.assert_array_equal(_bits32(s), _bits32(sr))
    qbuf = torch.zeros(n + off, dtype=torch.int8)
    qv = qbuf[off:]
    qv.copy_(q)
    np.testing.assert_array_equal(
        _bits32(ops.dequantize_blockwise(qv, s)),
        _bits32(jref.dequantize_blockwise_ref(qr, sr))[:n])


@pytest.mark.parametrize("name", sorted(pq8.SIGNATURES))
def test_entry_points_match_the_cuda_source(name):
    """The ctypes signatures and dtype codes the wrapper binds are the
    ones ``csrc/quant8.cu`` exports (no compiler here to catch a
    mismatch)."""
    import ctypes
    import re
    from repro_torch.kernels import build
    src = (build.CSRC / "quant8.cu").read_text()
    c_type = {"void*": ctypes.c_void_p, "const void*": ctypes.c_void_p,
              "signed char*": ctypes.c_void_p, "float*": ctypes.c_void_p,
              "const signed char*": ctypes.c_void_p,
              "const float*": ctypes.c_void_p, "int": ctypes.c_int,
              "long long": ctypes.c_longlong}
    m = re.search(rf"\nint {name}\(([^)]*)\)", src)
    params = [re.sub(r"\s*\w+$", "", p.strip())
              for p in m.group(1).split(",")]
    assert [c_type[p] for p in params] == pq8.SIGNATURES[name]
    assert "enum Dtype { kF32 = 0, kBF16 = 1 };" in src
    assert f"constexpr int kBlock = {BLOCK};" in src
    assert pq8._DTYPE_CODE == {torch.float32: 0, torch.bfloat16: 1}
