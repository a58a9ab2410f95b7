"""The hand-written flash-attention kernel on the card.

These tests need a CUDA device and no JAX, so they run on the GPU
machine (``python -m pytest tests/test_torch_flash_kernel.py -m gpu``)
and skip elsewhere.  On a CUDA tensor ``ops.flash_attention`` must launch
the kernel its dtypes choose (bf16: ``wgmma``, else ``simt``; the total
and that kernel's count grow by one), return a CUDA tensor and agree
with the plain version within the reference's tolerances; the bf16
kernel must also agree with the f32 oracle; a prefill of a smoke model
must launch it once per layer and agree with the same prefill through
``masked_attention``.
"""

import numpy as np
import pytest
import torch

from repro_torch import serve
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as pfa
from repro_torch.kernels import ops, ref
from repro_torch.models import lm

F32, BF16 = torch.float32, torch.bfloat16
TOL = {F32: 2e-5, BF16: 2e-2}

# (b, h, hkv, sq, sk, d, causal, window, softcap, dtype): the reference's
# cases (tests/test_kernels.py), the ragged and head-dim edges, and bf16
# mixed with f32 (the SIMT kernel).
CASES = [
    (1, 2, 2, 128, 128, 64, True, 0, None, F32),
    (2, 4, 2, 128, 128, 64, True, 0, None, F32),
    (1, 8, 1, 64, 64, 128, True, 0, None, F32),
    (1, 2, 2, 256, 256, 64, True, 64, None, F32),
    (1, 2, 2, 128, 128, 64, True, 0, 50.0, F32),
    (1, 2, 2, 128, 128, 64, True, 32, 30.0, F32),
    (1, 2, 2, 100, 100, 64, True, 0, None, F32),
    (1, 2, 2, 1, 256, 64, False, 0, None, F32),
    (1, 2, 2, 128, 128, 64, True, 0, None, BF16),
    (1, 4, 4, 128, 128, 256, True, 0, None, F32),
    (2, 4, 2, 1000, 1000, 16, True, 0, None, BF16),
    (1, 16, 8, 300, 300, 256, True, 128, 50.0, BF16),
    (1, 2, 2, 100, 100, 8, True, 0, None, BF16),
    (1, 2, 2, 1, 256, 64, False, 0, None, BF16),
    (1, 4, 2, 1000, 1000, 64, True, 0, None, BF16),
    (1, 2, 2, 128, 128, 64, True, 0, None, (BF16, BF16, F32)),
]


def _inputs(case, device):
    b, h, hkv, sq, sk, d, *_, dtype = case
    dts = dtype if isinstance(dtype, tuple) else (dtype,) * 3
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(device, dt) for s, dt in zip(
                     ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)), dts))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernel_matches_plain_version(case, cuda_device):
    *_, causal, window, softcap, _ = case
    q, k, v = _inputs(case, cuda_device)
    kw = dict(causal=causal, window=window, softcap=softcap)
    variant = pfa.kernel_variant(q.dtype, k.dtype, v.dtype)
    before = dict(pfa.LAUNCHES)
    got = ops.flash_attention(q, k, v, **kw)
    assert pfa.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    for name in ("wgmma", "simt"):
        key = f"flash_attention_{name}"
        assert pfa.LAUNCHES[key] == before[key] + (name == variant)
    assert got.device.type == "cuda" and got.dtype == q.dtype
    want = pfa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = TOL[q.dtype]  # a bf16 output is rounded to bf16, whichever kernel
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [c for c in CASES if c[-1] == BF16])
def test_bf16_kernel_matches_f32_oracle(case, cuda_device):
    """The wgmma kernel (P rounded to bf16) against the exact f32-P
    oracle on the same bf16 operands, within the bf16 tolerance."""
    *_, causal, window, softcap, _ = case
    q, k, v = _inputs(case, cuda_device)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ops.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.cpu().numpy(), rtol=TOL[BF16],
                               atol=TOL[BF16])


@pytest.mark.gpu
def test_prefill_launches_kernel_per_layer(cuda_device):
    cfg = get_smoke_config("gemma2-9b")  # window, softcaps, head dim 32
    model = serve.build_model(cfg, 0, cuda_device)
    prompt = serve.make_prompts(cfg, 2, 48, 1, cuda_device)
    before = pfa.LAUNCHES["flash_attention"]
    got, _ = lm.prefill(cfg, model, {"tokens": prompt})
    assert pfa.LAUNCHES["flash_attention"] == before + cfg.n_layers
    want, _ = lm.prefill(cfg, model, {"tokens": prompt}, flash=False)
    assert pfa.LAUNCHES["flash_attention"] == before + cfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    assert serve.check_consistency(cfg, model, prompt) < \
        serve.CONSISTENCY_TOL
