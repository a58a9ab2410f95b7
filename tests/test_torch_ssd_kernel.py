"""The hand-written SSD scan kernels (``csrc/ssd_scan.cu``) and their
route through ``kernels.ops.ssd_scan``.

The ``gpu`` tests need a CUDA device and no JAX, so they run on the GPU
machine (``python -m pytest tests/test_torch_ssd_kernel.py -m gpu``) and
skip elsewhere.  On a CUDA tensor ``ops.ssd_scan`` must launch the chain
of three kernels once (each count grows by one), and agree with the
plain version, ``models.mamba.ssd_chunked`` in f32: y and the final
state within 2e-5 of each output's largest magnitude on f32 inputs; on
bf16 inputs y within one bf16 rounding of the plain path's f32 y (plus
that f32 tolerance), the state within the f32 tolerance.  A smoke
mamba2 prefill must launch the chain once a layer and agree with the
same prefill on the CPU.

The CPU tests hold the dispatch (``ssd_chunked`` wherever autograd
records, the op elsewhere), the op's fake route and FLOP formula (equal
to the benchmark's yardstick), the refusal of mixed dtypes and the
library's signature.
"""

import copy
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import serve
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as pssd
from repro_torch.models import lm
from repro_torch.models import mamba as pmamba

F32, BF16 = torch.float32, torch.bfloat16
F32_TOL = 2e-5
BF16_ROUND = 2.0 ** -8   # one rounding to bf16: half an ulp, relative

# (b, l, h, p, g, n, chunk, init_state): mamba2-780m's widths with a
# ragged l, l < chunk with two groups, hymba-1.5b's P 100 and N 16, the
# smoke configurations' (P 16, N 8 and 16, Q 16), a group per head.
CASES = [
    (2, 300, 4, 64, 1, 128, 256, False),
    (1, 100, 4, 16, 2, 8, 256, True),
    (2, 64, 6, 100, 1, 16, 256, True),
    (1, 50, 4, 16, 1, 16, 16, False),
    (1, 48, 4, 16, 4, 8, 16, True),
    (3, 513, 2, 64, 1, 128, 256, True),
]


def _inputs(case, dtype, device, seed=0):
    b, l, h, p, g, n, _, init = case
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, dt=F32):
        return torch.from_numpy((scale * rng.standard_normal(shape))
                                .astype(np.float32)).to(device, dt)
    x = t(b, l, h, p, dt=dtype)
    dt = torch.nn.functional.softplus(t(b, l, h) - 1.0)
    A = -torch.exp(torch.from_numpy(rng.uniform(0, np.log(16), h)
                                    .astype(np.float32))).to(device)
    B, C = t(b, l, g, n, dt=dtype), t(b, l, g, n, dt=dtype)
    D = t(h)
    s0 = t(b, h, p, n) if init else None
    return x, dt, A, B, C, D, s0


def _cut_heads(device):
    """The tensor-parallel inputs of ``mamba_fwd``: a block of d_inner
    channels that cuts its first and last head (the channels held
    elsewhere zero) and each held head's B/C group gathered from a
    block of two-head groups."""
    b, l, h, p, g, n = 2, 70, 4, 16, 3, 8
    x, dt, A, B, C, D, s0 = _inputs((b, l, 6, p, g, n, 16, True), F32,
                                    device, seed=5)
    heads = torch.arange(1, 1 + h, device=device)
    x = x[:, :, 1:1 + h].clone()
    x[:, :, 0, :5] = 0
    x[:, :, -1, 11:] = 0
    groups = heads // 2
    return (x, dt[:, :, 1:1 + h].contiguous(), A[1:1 + h].contiguous(),
            B[:, :, groups].contiguous(), C[:, :, groups].contiguous(),
            D[1:1 + h].contiguous(), s0[:, 1:1 + h].contiguous())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _check(args, chunk):
    x = args[0]
    before = dict(pssd.LAUNCHES)
    y, final = ops.ssd_scan(*args[:6], chunk, init_state=args[6])
    assert all(pssd.LAUNCHES[k] == before[k] + 1 for k in pssd.LAUNCHES)
    assert y.device.type == "cuda" and y.dtype == x.dtype
    assert final.dtype == F32 and final.shape == (
        x.shape[0], x.shape[2], x.shape[3], args[3].shape[3])
    wy, wf = pmamba.ssd_chunked(
        x.float(), args[1], args[2], args[3].float(), args[4].float(),
        args[5], chunk, init_state=args[6])
    torch.cuda.synchronize()
    assert _rel(final, wf) <= F32_TOL
    if x.dtype == F32:
        assert _rel(y, wy) <= F32_TOL
    else:
        err = (y.float() - wy).abs()
        assert bool((err <= BF16_ROUND * wy.abs()
                     + F32_TOL * wy.abs().max()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernel_matches_plain_version(case, dtype, cuda_device):
    _check(_inputs(case, dtype, cuda_device), case[6])


@pytest.mark.gpu
def test_cuda_kernel_on_cut_tensor_parallel_heads(cuda_device):
    args = _cut_heads(cuda_device)
    _check(args, 16)
    _check(tuple(a.to(BF16) if i in (0, 3, 4) else a
                 for i, a in enumerate(args)), 16)


@pytest.mark.gpu
def test_prefill_launches_kernels_per_layer(cuda_device):
    cfg = get_smoke_config("mamba2-780m")
    model = serve.build_model(cfg, 0, cuda_device)
    prompt = serve.make_prompts(cfg, 2, 40, 1, cuda_device)
    before = dict(pssd.LAUNCHES)
    got, _ = lm.prefill(cfg, model, {"tokens": prompt})
    assert all(pssd.LAUNCHES[k] == before[k] + cfg.n_layers
               for k in pssd.LAUNCHES)
    want, _ = lm.prefill(cfg, copy.deepcopy(model).cpu(),
                         {"tokens": prompt.cpu()})
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# CPU: the route, the fake op, the FLOP formula, the plan
# ---------------------------------------------------------------------------

def _smoke_mamba(requires_grad: bool):
    cfg = get_smoke_config("mamba2-780m")
    mc, d = cfg.mamba, cfg.d_model
    p = pmamba.init_mamba(pmamba.Mamba(d, mc, dtype=F32, device="cpu"),
                          torch.Generator().manual_seed(0))
    p.requires_grad_(requires_grad)
    x = torch.randn(2, 40, d, generator=torch.Generator().manual_seed(1))
    return p, x, mc, d


@pytest.mark.parametrize("grad", [True, False])
def test_dispatch_takes_ssd_chunked_where_autograd_records(grad,
                                                           monkeypatch):
    """Parameters that require a gradient under grad mode (training) run
    ``ssd_chunked``; ``no_grad`` or parameters without gradients run the
    op, whose CPU route is ``ssd_chunked`` on f32 copies: the same
    numbers."""
    p, x, mc, d = _smoke_mamba(grad)
    seen = []
    real_chunked, real_op = pmamba.ssd_chunked, ops.ssd_scan

    def chunked(*a, **k):
        seen.append("ssd_chunked")
        return real_chunked(*a, **k)

    def op(*a, **k):
        seen.append("op")
        return real_op(*a, **k)
    monkeypatch.setattr(pmamba, "ssd_chunked", chunked)
    monkeypatch.setattr(ops, "ssd_scan", op)
    got, _ = pmamba.mamba_fwd(p, x, mc=mc, d_model=d)
    assert seen == (["ssd_chunked"] if grad else ["op", "ssd_chunked"])
    assert got.requires_grad == grad
    seen.clear()
    with torch.no_grad():
        again, _ = pmamba.mamba_fwd(p, x, mc=mc, d_model=d)
    assert seen == ["op", "ssd_chunked"]
    assert torch.equal(got.detach(), again)


def test_plain_route_is_ssd_chunked_rounded_once():
    args = _inputs(CASES[4], BF16, "cpu")
    before = dict(pssd.LAUNCHES)
    y, final = ops.ssd_scan(*args[:6], 16, init_state=args[6])
    wy, wf = pmamba.ssd_chunked(args[0].float(), args[1], args[2],
                                args[3].float(), args[4].float(), args[5],
                                16, init_state=args[6])
    assert y.dtype == BF16 and torch.equal(y, wy.to(BF16))
    assert torch.equal(final, wf)
    assert pssd.LAUNCHES == before


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_fake_route_shapes_and_dtypes(dtype):
    b, l, h, p, g, n = 2, 300, 6, 100, 3, 16
    with FakeTensorMode():
        y, final = ops.ssd_scan(
            torch.empty(b, l, h, p, dtype=dtype), torch.empty(b, l, h),
            torch.empty(h), torch.empty(b, l, g, n, dtype=dtype),
            torch.empty(b, l, g, n, dtype=dtype), torch.empty(h), 256,
            init_state=torch.empty(b, h, p, n))
        assert y.shape == (b, l, h, p) and y.dtype == dtype
        assert final.shape == (b, h, p, n) and final.dtype == F32
        with pytest.raises(ValueError):
            ops.ssd_scan(torch.empty(b, l, h, p), torch.empty(b, l, h),
                         torch.empty(h), torch.empty(b, l, 4, n),
                         torch.empty(b, l, 4, n), torch.empty(h), 256)


@pytest.mark.parametrize("shape", [(8, 8192, 48, 64, 1, 128, 256),
                                   (8, 1000, 32, 100, 1, 16, 256),
                                   (2, 40, 8, 16, 1, 16, 16),
                                   (1, 7, 4, 16, 4, 8, 16)])
def test_flop_formula_equals_yardstick(shape):
    """``ops.ssd_flops`` (the op's registered formula) equals the
    benchmark's ``yardstick.mixer_flops`` for a Mamba-2 layer of the same
    shape, and ``FlopCounterMode`` counts the op by it."""
    from perfbench import yardstick
    from perfbench.sizes import Sizes
    b, l, h, p, g, n, q = shape
    s = Sizes(family="mamba2", name="t", n_layers=1, d_model=h * p // 2,
              vocab=16, token_ids=16, tie=True, eps=1e-5, d_inner=h * p,
              m_heads=h, m_head_dim=p, d_state=n, n_groups=g, chunk=q)
    assert ops.ssd_flops(b, l, h, p, g, n, q) == \
        yardstick.mixer_flops(s, b, l)
    with FakeTensorMode():
        args = (torch.empty(b, l, h, p, dtype=BF16), torch.empty(b, l, h),
                torch.empty(h), torch.empty(b, l, g, n, dtype=BF16),
                torch.empty(b, l, g, n, dtype=BF16), torch.empty(h))
        with FlopCounterMode(display=False) as fc:
            ops.ssd_scan(*args, q)
    assert fc.get_total_flops() == yardstick.mixer_flops(s, b, l)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func._overloadpacket))
        return func(*args, **(kwargs or {}))


def test_traced_prefill_goes_through_the_op():
    """A mamba2 smoke prefill traced on fake tensors, as the dry run
    traces a step, holds one ``repro_torch::ssd_scan`` a layer and none
    of ``ssd_chunked``'s einsums; nothing launches."""
    cfg = get_smoke_config("mamba2-780m")
    before = dict(pssd.LAUNCHES)
    with FakeTensorMode():
        model = lm.LM(cfg, device="cpu")
        tokens = torch.zeros(2, 40, dtype=torch.int64)
        with _Ops() as spy:
            lm.prefill(cfg, model, {"tokens": tokens})
    assert spy.names.count("repro_torch.ssd_scan") == cfg.n_layers
    assert "aten.cumsum" not in spy.names
    assert pssd.LAUNCHES == before


@pytest.mark.parametrize("odd", ["x", "B", "C"])
def test_mixed_dtypes_are_refused(odd):
    """x, B and C come in one dtype (``mamba_fwd`` passes them so); one of
    another dtype raises on the CPU's plain route and on fake tensors."""
    def run():
        t = {"x": torch.randn(1, 20, 4, 8), "B": torch.randn(1, 20, 1, 4),
             "C": torch.randn(1, 20, 1, 4)}
        t[odd] = t[odd].to(BF16)
        ops.ssd_scan(t["x"], torch.rand(1, 20, 4), -torch.rand(4), t["B"],
                     t["C"], torch.randn(4), 16)
    with pytest.raises(TypeError, match="all f32 or all bf16"):
        run()
    with FakeTensorMode(), pytest.raises(TypeError,
                                         match="all f32 or all bf16"):
        run()


def test_signature_matches_the_source():
    src = (Path(pssd.__file__).resolve().parent.parent / "csrc"
           / "ssd_scan.cu").read_text()
    decl = re.search(r"int ssd_scan\(([^)]*)\)", src).group(1)
    params = [a.strip() for a in decl.split(",")]
    assert len(params) == len(pssd.SIGNATURE)
    for a, t in zip(params, pssd.SIGNATURE):
        assert ("*" in a) == (t is pssd._VP), a
    names = set(re.findall(r"__global__ void __launch_bounds__\([^)]*\)"
                           r" (\w+)\(", src))
    assert names == {f"{k}_kernel" for k in pssd.KERNELS}


def test_first_call_imports_no_compiler():
    """The op's first call (in a served cell's set-up) imports nothing of
    torch's compiler stack: a ``custom_op`` kernel's first call would
    import ``torch._dynamo``, seconds on the card's host."""
    code = ("import sys, torch\n"
            "from repro_torch.kernels import ops\n"
            "x = torch.randn(1, 20, 4, 8)\n"
            "B = torch.randn(1, 20, 1, 4)\n"
            "with torch.no_grad():\n"
            "    ops.ssd_scan(x, torch.rand(1, 20, 4), -torch.rand(4), B, B,"
            " torch.randn(4), 16)\n"
            "print('torch._dynamo' in sys.modules)\n")
    src = str(Path(pssd.__file__).resolve().parents[2])
    env = {**os.environ, "PYTHONPATH": src}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "False"
