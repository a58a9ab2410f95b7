"""The port's flash attention against the JAX package's.

The port's plain version (``flash_attention_plain``) and its public
wrapper ``ops.flash_attention`` on CPU tensors are held against the
Pallas kernel in interpret mode and against ``ref.flash_attention_ref``
on the reference's own cases and tolerances; the port's model-path
``masked_attention`` against the JAX one and against the flash plain
version.  The hand-written CUDA kernel itself runs only on a card; its
tests, which need no JAX, are in ``test_torch_flash_kernel.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models.attention import masked_attention as jax_masked
from repro_torch.kernels import flash_attention as pfa
from repro_torch.kernels import ops, ref as pref
from repro_torch.models.attention import masked_attention as port_masked
from test_kernels import FLASH_CASES

TOL = {jnp.float32: 2e-5, jnp.bfloat16: 2e-2}


def _inputs(seed, shapes, dtype):
    """The same seeded values for both frameworks: f32 NumPy, rounded
    to ``dtype`` by each framework (both round to nearest even)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return ([jnp.asarray(a).astype(dtype) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize(
    "b,h,hkv,sq,sk,d,causal,window,softcap,dtype", FLASH_CASES)
def test_plain_version_matches_pallas_and_ref(b, h, hkv, sq, sk, d, causal,
                                              window, softcap, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        0, [(b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)], dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    pallas = pallas_flash(jq, jk, jv, block_q=64, block_k=64,
                          interpret=True, **kw)
    oracle = jref.flash_attention_ref(jq, jk, jv, **kw)
    plain = pfa.flash_attention_plain(tq, tk, tv, **kw)
    via_ops = ops.flash_attention(tq, tk, tv, **kw)
    assert plain.dtype == tq.dtype and plain.shape == tq.shape
    assert torch.equal(via_ops, plain)  # CPU tensors: the plain version
    tol = TOL[dtype]
    for want in (pallas, oracle):
        np.testing.assert_allclose(_f32(plain), _f32(want), rtol=tol,
                                   atol=tol)
    np.testing.assert_allclose(
        _f32(pref.flash_attention_ref(tq, tk, tv, **kw)), _f32(oracle),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("seed,window,kv", [(0, 0, 1), (1, 32, 2),
                                            (2, 0, 4), (3, 32, 4)])
def test_model_path_matches_flash_plain(seed, window, kv):
    """TestAttentionConsistency on the port: the chunked model path and
    the kernel's plain version agree."""
    b, h, s, d = 1, 4, 128, 32
    _, (q, k, v) = _inputs(seed, [(b, s, h, d), (b, s, kv, d),
                                  (b, s, kv, d)], jnp.float32)
    model = port_masked(q, k, v, q_pos=torch.arange(s),
                        k_pos=torch.arange(s), window=window,
                        scale=d ** -0.5, q_chunk=64)
    kern = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True,
                               window=window)
    np.testing.assert_allclose(model.numpy(), kern.transpose(1, 2).numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sq,window,cap,decode", [
    (128, 0, None, False), (256, 48, 50.0, False), (96, 0, None, False),
    (1, 0, None, True), (1, 16, 30.0, True)])
def test_masked_attention_matches_jax(sq, window, cap, decode):
    """The port's query-chunked model path against the JAX one, in
    prefill form (1-D positions, chunked when Sq is a multiple of the
    chunk) and in decode form (per-batch positions)."""
    b, h, kv, sk, d = 2, 4, 2, (64 if decode else sq), 16
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        1, [(b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)], jnp.float32)
    if decode:
        pos = np.array([[17], [63]])
        jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    else:
        jpos, tpos = jnp.arange(sq), torch.arange(sq)
    kw = dict(window=window, attn_softcap=cap, scale=d ** -0.5, q_chunk=32)
    want = jax_masked(jq, jk, jv, q_pos=jpos, k_pos=jnp.arange(sk), **kw)
    got = port_masked(tq, tk, tv, q_pos=tpos, k_pos=torch.arange(sk), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_shapes():
    _, (q, k, v) = _inputs(0, [(1, 4, 8, 64), (1, 2, 8, 64),
                               (1, 2, 8, 64)], jnp.float32)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        pfa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q[..., :12], k[..., :12], v[..., :12])
    with pytest.raises(ValueError, match="Hkv not dividing H"):
        ops.flash_attention(q[:, :3], k, v)
    with pytest.raises(TypeError, match="f32 or bf16"):
        ops.flash_attention(q.double(), k, v)


def test_plain_version_masks_padded_keys_and_empty_rows():
    """Keys padded to the block multiple never leak, and a row whose
    every key lies outside its window outputs zero."""
    _, (q, k, v) = _inputs(3, [(1, 2, 70, 16), (1, 2, 70, 16),
                               (1, 2, 70, 16)], jnp.float32)
    got = pfa.flash_attention_plain(q, k, v, causal=False)
    want = torch.softmax(q @ k.transpose(-1, -2) * 16 ** -0.5, -1) @ v
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    # row 0 of a causal mask sees key 0 only
    out = pfa.flash_attention_plain(q[:, :, :1], k, v, causal=True)
    np.testing.assert_allclose(out[0, :, 0].numpy(), v[0, :, 0].numpy(),
                               rtol=2e-5, atol=2e-5)
    # 70 queries, 20 keys, window 5: rows from 24 on keep no key
    out = pfa.flash_attention_plain(q, k[:, :, :20], v[:, :, :20],
                                    causal=True, window=5)
    assert torch.equal(out[:, :, 24:], torch.zeros_like(out[:, :, 24:]))
    assert bool((out[:, :, :24].abs().sum(-1) > 0).all())
