"""Bucket pack/unpack: the port's plain versions against the JAX package.

The plain versions (``bucket_pack_plain`` / ``bucket_unpack_plain``),
which the ``ops`` entry points take for CPU tensors and which the CUDA
kernels are held to bit for bit on the card, must equal the JAX
package's oracles (``bucket_pack_ref`` / ``bucket_unpack_ref``) and its
Pallas kernels in interpret mode bit for bit, on the JAX kernel tests'
leaf sets (``tests/test_kernels.py``), with the bf16 cast.  The kernel
wrappers refuse CPU tensors.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.bucket_pack import bucket_pack as jpack
from repro.kernels.bucket_pack import bucket_unpack as junpack
from repro_torch.kernels import bucket_pack as pbp
from repro_torch.kernels import ops
from repro_torch.kernels import ref as pref

# tests/test_kernels.py's LEAF_SETS, and scalar leaves and sizes around
# the Pallas kernel's 128-lane rows
LEAF_SETS = [
    [(4, 8), (16,), (3, 5, 7)],
    [(128,)],
    [(1,), (1,), (1,)],
    [(256, 128), (64,), (13,)],
    [(), (127,), (129,), ()],
]
DT = {"float32": (np.float32, torch.float32, jnp.float32),
      "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, jnp.bfloat16)}


def _leaves(shapes, dtype, seed=0):
    """Seeded leaves as (NumPy in the dtype, torch) pairs."""
    rng = np.random.default_rng(seed)
    npdt, tdt, _ = DT[dtype]
    arrs = [rng.standard_normal(s).astype(np.float32).astype(npdt)
            for s in shapes]
    return arrs, [torch.from_numpy(np.asarray(a, np.float32)).to(tdt)
                  for a in arrs]


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("shapes", LEAF_SETS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out", [None, "float32", "bfloat16"])
def test_pack_plain_equals_jax(shapes, dtype, out):
    arrs, ts = _leaves(shapes, dtype)
    out_t = None if out is None else DT[out][1]
    out_j = None if out is None else DT[out][2]
    got = pbp.bucket_pack_plain(ts, out_t)
    want = jref.bucket_pack_ref([jnp.asarray(a) for a in arrs], out_j)
    pallas = jpack([jnp.asarray(a) for a in arrs], out_j, interpret=True)
    assert str(got.dtype).split(".")[1] == str(want.dtype) == \
        str(pallas.dtype)
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    np.testing.assert_array_equal(_np(got), np.asarray(pallas, np.float32))
    assert torch.equal(ops.bucket_pack(ts, out_t), got)


@pytest.mark.parametrize("shapes", LEAF_SETS)
@pytest.mark.parametrize("flat_dtype,leaf_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "float32"), ("bfloat16", "bfloat16")])
def test_unpack_plain_equals_jax(shapes, flat_dtype, leaf_dtype):
    """Every dtype pair: the flat bucket in one, the templates in the
    other."""
    n = sum(int(np.prod(s)) for s in shapes)
    (flat_np,), (flat,) = _leaves([(n,)], flat_dtype, seed=1)
    tmpl_np, tmpl = _leaves(shapes, leaf_dtype, seed=2)
    got = pbp.bucket_unpack_plain(flat, tmpl)
    want = jref.bucket_unpack_ref(jnp.asarray(flat_np),
                                  [jnp.asarray(a) for a in tmpl_np])
    pallas = junpack(jnp.asarray(flat_np), [jnp.asarray(a) for a in tmpl_np],
                     interpret=True)
    for g, w, p, t in zip(got, want, pallas, tmpl):
        assert g.shape == t.shape and g.dtype == t.dtype
        np.testing.assert_array_equal(_np(g), np.asarray(w, np.float32))
        np.testing.assert_array_equal(_np(g), np.asarray(p, np.float32))
    into = [torch.empty_like(t) for t in tmpl]
    res = ops.bucket_unpack(flat, tmpl, out=into)
    assert all(r is o for r, o in zip(res, into))
    assert all(torch.equal(a, b) for a, b in zip(into, got))


@pytest.mark.parametrize("shapes", LEAF_SETS)
def test_round_trip(shapes):
    _, ts = _leaves(shapes, "float32", seed=3)
    back = ops.bucket_unpack(ops.bucket_pack(ts), ts)
    assert all(torch.equal(a, b) for a, b in zip(ts, back))


def test_stacked_leaf_segments_ravel_like_the_stacked_array():
    """A leaf stacked on a layer axis, passed as one segment per layer,
    packs to the bytes of JAX's stacked array."""
    rng = np.random.default_rng(5)
    stacked = rng.standard_normal((16, 8, 2, 4)).astype(np.float32)
    other = rng.standard_normal((3,)).astype(np.float32)
    segs = [torch.from_numpy(other)] + [torch.from_numpy(stacked[i])
                                        for i in range(16)]
    got = ops.bucket_pack(segs)
    want = jref.bucket_pack_ref([jnp.asarray(other), jnp.asarray(stacked)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    outs = [torch.empty_like(s) for s in segs]
    ops.bucket_unpack(got, segs, out=outs)
    np.testing.assert_array_equal(torch.stack(outs[1:]).numpy(), stacked)


def test_many_segments():
    _, ts = _leaves([(int(k) % 37 + 1,) for k in range(300)], "bfloat16",
                    seed=6)
    flat = ops.bucket_pack(ts, torch.float32)
    assert torch.equal(flat, pref.bucket_pack_ref(ts, torch.float32))
    back = ops.bucket_unpack(flat, ts)
    assert all(torch.equal(a, b) for a, b in zip(ts, back))


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_operands():
    t = torch.ones(4)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        pbp.bucket_pack([t])
    with pytest.raises(ValueError, match="not on a CUDA device"):
        pbp.bucket_unpack(t, [t])
    with pytest.raises(TypeError, match="not f32 or bf16"):
        ops.bucket_pack([t.double()])
    with pytest.raises(ValueError, match="no segments"):
        ops.bucket_pack([])
    with pytest.raises(ValueError, match="vector of 5"):
        ops.bucket_unpack(t, [torch.ones(5)])
    assert pbp.LAUNCHES == {"bucket_pack": 0, "bucket_unpack": 0}
