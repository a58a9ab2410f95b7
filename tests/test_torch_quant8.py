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
