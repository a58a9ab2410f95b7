"""The bf16 flash kernel's tiling, held on the CPU.

The port's bf16 flash attention runs on the ``wgmma`` kernel, whose
arithmetic its plain version repeats: the key blocks of
``tile_schedule``, an online softmax per key tile, P rounded to bf16
before P.V.  Here ``tile_schedule`` is held against a brute-force mask,
the bf16 plain version against the Pallas kernel in interpret mode and
the JAX oracle, and the dtype dispatch against its rule.  The kernel
itself runs only on a card (``test_torch_flash_kernel.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import flash_attention as pfa
from repro_torch.kernels import ops
from test_kernels import FLASH_CASES

TOL = 2e-2  # the reference's bf16 tolerance (tests/test_kernels.py)
BF16 = torch.bfloat16


def _kept(sq, sk, causal, window):
    rows = np.arange(sq)[:, None]
    cols = np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= cols <= rows
    if window > 0:
        keep &= (rows - cols) < window
    return keep


@pytest.mark.parametrize("window", [0, 1, 32, 96])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sk", [1, 63, 64, 65, 100, 1000])
@pytest.mark.parametrize("sq", [1, 63, 64, 65, 100, 1000])
def test_tile_schedule_covers_the_mask(sq, sk, causal, window):
    """Every kept (row, col) pair lies in a visited block, no skipped
    block holds one, and a block visited without the mask keeps every
    pair of the query block's real rows.  Both key-tile sizes."""
    keep = _kept(sq, sk, causal, window)
    for bk in sorted(set(pfa.BLOCK_K.values())):
        bq = pfa.BLOCK_Q
        sched = pfa.tile_schedule(sq, sk, causal, window, bq, bk)
        assert len(sched) == -(-sq // bq)
        n_kb = -(-sk // bk)
        for qb, blocks in enumerate(sched):
            rows = keep[qb * bq:(qb + 1) * bq]
            kbs = [kb for kb, _ in blocks]
            assert kbs == sorted(set(kbs))
            for kb in range(n_kb):
                tile = rows[:, kb * bk:(kb + 1) * bk]
                if kb not in kbs:
                    assert not tile.any(), (qb, kb)
            for kb, masked in blocks:
                assert 0 <= kb < n_kb
                tile = rows[:, kb * bk:(kb + 1) * bk]
                if not masked:
                    assert tile.shape[1] == bk and tile.all(), (qb, kb)


def test_tile_schedule_skips_blocks():
    """The schedule visits only the causal triangle and the window band:
    at 1024 tokens and 128-key tiles, 36 of 64 blocks, 8 of them on the
    diagonal; with a window of 256 the band's 21."""
    sched = pfa.tile_schedule(1024, 1024, True, 0, 128, 128)
    assert sum(len(b) for b in sched) == 36
    assert sum(m for b in sched for _, m in b) == 8
    band = pfa.tile_schedule(1024, 1024, True, 256, 128, 128)
    assert [len(b) for b in band] == [1, 2, 3, 3, 3, 3, 3, 3]
    assert pfa.block_k(64) == pfa.block_k(128) == 128
    assert pfa.block_k(136) == pfa.block_k(256) == 64


# the reference's cases without their dtype (two of them then coincide)
BF16_CASES = (
    list(dict.fromkeys(c[:-1] for c in FLASH_CASES))
    + [(1, 2, 2, 100, 100, 8, True, 0, None),
       (1, 4, 2, 128, 128, 16, True, 0, None),
       (1, 4, 2, 200, 200, 256, True, 96, 50.0)])


def _bf16_inputs(seed, b, h, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in arrs],
            [torch.from_numpy(a).to(BF16) for a in arrs])


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal,window,softcap",
                         BF16_CASES)
def test_bf16_plain_version_matches_pallas_and_oracle(b, h, hkv, sq, sk, d,
                                                      causal, window,
                                                      softcap):
    """bf16 variants of the reference's ten cases, plus D 8, D 16 and a
    D 256 window-and-softcap case, within the reference's 2e-2."""
    (jq, jk, jv), (tq, tk, tv) = _bf16_inputs(0, b, h, hkv, sq, sk, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    plain = pfa.flash_attention_plain(tq, tk, tv, **kw)
    assert plain.dtype == BF16 and plain.shape == tq.shape
    assert torch.equal(ops.flash_attention(tq, tk, tv, **kw), plain)
    pallas = pallas_flash(jq, jk, jv, block_q=64, block_k=64,
                          interpret=True, **kw)
    oracle = jref.flash_attention_ref(jq, jk, jv, **kw)
    got = plain.float().numpy()
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=TOL, atol=TOL)


def test_bf16_plain_version_rounds_p_per_tile():
    """P is rounded to bf16 before P.V: the plain version differs from
    the f32-P oracle on the same bf16 operands, by less than the
    tolerance, and a row with no kept key outputs 0."""
    _, (q, k, v) = _bf16_inputs(1, 1, 2, 1, 300, 300, 64)
    plain = pfa.flash_attention_plain(q, k, v, causal=True).float()
    exact = pfa.ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                        causal=True)
    err = float((plain - exact).abs().max())
    assert 0.0 < err < TOL
    out = pfa.flash_attention_plain(q, k[:, :, :20], v[:, :, :20],
                                    causal=True, window=5)
    assert torch.equal(out[:, :, 24:], torch.zeros_like(out[:, :, 24:]))


@pytest.mark.parametrize("dtypes,variant", [
    ((BF16, BF16, BF16), "wgmma"),
    ((torch.float32,) * 3, "simt"),
    ((BF16, BF16, torch.float32), "simt"),
    ((torch.float32, BF16, BF16), "simt"),
    ((BF16, torch.float32, BF16), "simt"),
])
def test_dtype_dispatch(dtypes, variant):
    """bf16 operands go to the wgmma kernel; f32, or bf16 mixed with f32
    (which promotes to f32), to the SIMT kernel; the plain version
    follows the same rule."""
    assert pfa.kernel_variant(*dtypes) == variant
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dt) for s, dt in zip(((1, 2, 70, 16), (1, 1, 70, 16),
                                         (1, 1, 70, 16)), dtypes))
    plain = pfa.flash_attention_plain(q, k, v, causal=True)
    assert plain.dtype == q.dtype
    f32 = pfa.ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                      causal=True)
    if variant == "simt":  # exact f32 arithmetic
        np.testing.assert_allclose(plain.float().numpy(), f32.to(
            q.dtype).float().numpy(), rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(plain.float().numpy(), f32.numpy(),
                                   rtol=TOL, atol=TOL)
