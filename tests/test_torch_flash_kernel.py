"""The hand-written flash-attention kernel on the card.

These tests need a CUDA device and no JAX, so they run on the GPU
machine (``python -m pytest tests/test_torch_flash_kernel.py -m gpu``)
and skip elsewhere.  On a CUDA tensor ``ops.flash_attention`` must launch
the kernel (its count grows by one), return a CUDA tensor and agree with
the kernel's plain version within the reference's tolerances; a prefill
of the llama3.2-1b smoke model must launch it once per layer and agree
with the same prefill through ``masked_attention``.
"""

import numpy as np
import pytest
import torch

from repro_torch import serve
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as pfa
from repro_torch.kernels import ops
from repro_torch.models import lm

F32, BF16 = torch.float32, torch.bfloat16
TOL = {F32: 2e-5, BF16: 2e-2}

# (b, h, hkv, sq, sk, d, causal, window, softcap, dtype): the reference's
# cases (tests/test_kernels.py) and the ragged and head-dim edges.
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
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernel_matches_plain_version(case, cuda_device):
    b, h, hkv, sq, sk, d, causal, window, softcap, dtype = case
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda_device, dtype)
               for s in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = pfa.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, **kw)
    assert pfa.LAUNCHES["flash_attention"] == before + 1
    assert got.device.type == "cuda" and got.dtype == dtype
    want = pfa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


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
