"""The hand-written bucket pack/unpack and quant8 kernels on the card.

These tests need a CUDA device and no JAX, so they run on the GPU
machine (``python -m pytest tests/test_torch_train_kernels.py -m gpu``)
and skip elsewhere.  On CUDA tensors the ``ops`` entry points must
launch the kernels (each count grows by one) and equal the plain
versions bit for bit, also for segments, destinations and buckets that
are views at odd element offsets and for buckets above the by-value
descriptor capacity (the device-table route); a training step of the
llama3.2-1b smoke model must launch the pack kernels once per
multi-leaf bucket of the plan and agree with the same step on the CPU.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.core import bucketing
from repro_torch.data import pipeline
from repro_torch.kernels import bucket_pack as pbp
from repro_torch.kernels import ops
from repro_torch.kernels import quant8 as pq8
from repro_torch.launch import steps
from repro_torch.models import lm

F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _rand(shape, dtype, device, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32)) \
        .to(device, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("seg_dt,bucket_dt", [(F32, F32), (F32, BF16),
                                              (BF16, F32), (BF16, BF16)])
@pytest.mark.parametrize("sizes", [(1,), (13, 127, 128, 129), (),
                                   tuple(range(1, 301))])
def test_pack_unpack_bitwise(cuda_device, seg_dt, bucket_dt, sizes):
    segs = [_rand((n,) if n else (), seg_dt, cuda_device, i)
            for i, n in enumerate(sizes or (0,))]
    before = dict(pbp.LAUNCHES)
    flat = ops.bucket_pack(segs, bucket_dt)
    assert pbp.LAUNCHES["bucket_pack"] == before["bucket_pack"] + 1
    assert flat.device.type == "cuda" and flat.dtype == bucket_dt
    want = pbp.bucket_pack_plain(segs, bucket_dt)
    assert torch.equal(flat.view(torch.int16 if bucket_dt == BF16
                                 else torch.int32),
                       want.view(torch.int16 if bucket_dt == BF16
                                 else torch.int32))
    outs = [torch.empty_like(s) for s in segs]
    ops.bucket_unpack(flat, segs, out=outs)
    assert pbp.LAUNCHES["bucket_unpack"] == before["bucket_unpack"] + 1
    for o, w in zip(outs, pbp.bucket_unpack_plain(flat, segs)):
        assert torch.equal(o, w)


def _bits(t):
    return t.view(torch.int16 if t.dtype == BF16 else torch.int32)


def _views(buf, offsets, sizes):
    """Contiguous views of ``buf`` at the given element offsets."""
    return [buf[o:o + n] for o, n in zip(offsets, sizes)]


# sizes around a 16-byte vector and past one tile, at odd element offsets
MISALIGNED_SIZES = (1, 13, 127, 128, 129, 4099, 70001)
MISALIGNED_OFFSETS = (1, 3, 5, 7, 9, 11, 13)


@pytest.mark.gpu
@pytest.mark.parametrize("seg_dt,bucket_dt", [(F32, F32), (F32, BF16),
                                              (BF16, F32), (BF16, BF16)])
@pytest.mark.parametrize("flat_offset", [0, 1, 3])
def test_pack_unpack_bitwise_misaligned_views(cuda_device, seg_dt, bucket_dt,
                                              flat_offset):
    """Segments (and unpack's destinations and bucket) that are views at
    odd element offsets: heads, tails and all-scalar segments."""
    n_buf = sum(MISALIGNED_SIZES) + 16 * len(MISALIGNED_SIZES)
    offs = [sum(MISALIGNED_SIZES[:i]) + 16 * i + MISALIGNED_OFFSETS[i]
            for i in range(len(MISALIGNED_SIZES))]
    segs = _views(_rand((n_buf,), seg_dt, cuda_device, 7), offs,
                  MISALIGNED_SIZES)
    flat = ops.bucket_pack(segs, bucket_dt)
    want = pbp.bucket_pack_plain(segs, bucket_dt)
    assert torch.equal(_bits(flat), _bits(want))
    total = flat.numel()
    shifted = torch.empty(total + 8, dtype=bucket_dt, device=cuda_device)
    src = shifted[flat_offset:flat_offset + total]
    src.copy_(flat)
    outs = _views(torch.zeros(n_buf, dtype=seg_dt, device=cuda_device),
                  offs, MISALIGNED_SIZES)
    ops.bucket_unpack(src, segs, out=outs)
    for o, w in zip(outs, pbp.bucket_unpack_plain(src, segs)):
        assert torch.equal(_bits(o), _bits(w))
    if bucket_dt == F32:  # f32 holds every f32 and bf16 value: exact trip
        assert all(torch.equal(_bits(o), _bits(s))
                   for o, s in zip(outs, segs))


@pytest.mark.gpu
@pytest.mark.parametrize("seg_dt,bucket_dt", [(F32, F32), (BF16, F32),
                                              (F32, BF16)])
def test_pack_unpack_bitwise_above_capacity(cuda_device, seg_dt, bucket_dt):
    """More segments than a launch takes by value: the device-table
    route, one launch each way."""
    k = pbp.capacity() + 1
    segs = [_rand((i % 37 + 1,), seg_dt, cuda_device, i) for i in range(k)]
    before, routes = dict(pbp.LAUNCHES), dict(pbp.ROUTES)
    flat = ops.bucket_pack(segs, bucket_dt)
    outs = [torch.empty_like(s) for s in segs]
    ops.bucket_unpack(flat, segs, out=outs)
    assert pbp.LAUNCHES["bucket_pack"] == before["bucket_pack"] + 1
    assert pbp.LAUNCHES["bucket_unpack"] == before["bucket_unpack"] + 1
    assert pbp.ROUTES["table"] == routes["table"] + 2
    assert pbp.ROUTES["by_value"] == routes["by_value"]
    assert torch.equal(_bits(flat),
                       _bits(pbp.bucket_pack_plain(segs, bucket_dt)))
    for o, w in zip(outs, pbp.bucket_unpack_plain(flat, segs)):
        assert torch.equal(_bits(o), _bits(w))


def _bits(t):
    return t.view({F32: torch.int32, BF16: torch.int16}[t.dtype])


def _counted(fn, *args):
    """``fn(*args)``, with the launch and the route it took."""
    launches, routes = dict(pq8.LAUNCHES), dict(pq8.ROUTES)
    out = fn(*args)
    grew = {k: pq8.LAUNCHES[k] - launches[k] for k in launches}
    took = [k for k in routes if pq8.ROUTES[k] != routes[k]]
    return out, grew, took


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 255, 256, 257, 1 << 20, (1 << 22) + 100])
@pytest.mark.parametrize("scale", [1e-6, 1.0, 1e4])
@pytest.mark.parametrize("dtype,offset", [(F32, 0), (F32, 1), (BF16, 0),
                                          (BF16, 3)])
def test_quant8_bitwise(cuda_device, n, scale, dtype, offset):
    """Kernel against plain, bit for bit (scales as int32 patterns), on
    f32 and bf16 x, aligned and as a view at an odd element offset, with
    a zero block, a NaN block, +inf and -inf blocks and a NaN in the
    ragged tail; the int8 values dequantized aligned and from a view at
    an odd offset.  One launch a call, on the route its input picks
    (``vec`` only for aligned bf16 x and aligned int8 values)."""
    x = (_rand((n + offset,), F32, cuda_device, n) * scale)
    if n > 1024:
        x[:256] = 0.0  # an all-zero block
        x[300] = float("nan")
        x[600] = float("inf")
        x[900] = float("-inf")
    if n % 256 and n > 256:
        x[-1] = float("nan")  # in the ragged tail
    x = x.to(dtype)[offset:]
    route = "vec" if dtype == BF16 and not offset else "scalar"
    (q, s), grew, took = _counted(ops.quantize_blockwise, x)
    assert grew == {"quantize_blockwise": 1, "dequantize_blockwise": 0}
    assert took == [route] and pq8.route(x) == route
    y, grew, took = _counted(ops.dequantize_blockwise, q, s)
    assert grew == {"quantize_blockwise": 0, "dequantize_blockwise": 1}
    assert took == ["vec"]
    qbuf = torch.empty(n + 1, dtype=torch.int8, device=cuda_device)
    qv = qbuf[1:]
    qv.copy_(q)
    yv, grew, took = _counted(ops.dequantize_blockwise, qv, s)
    assert grew["dequantize_blockwise"] == 1 and took == ["scalar"]
    qw, sw = pq8.quantize_blockwise_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(q, qw)
    assert torch.equal(_bits(s), _bits(sw))
    yw = pq8.dequantize_blockwise_plain(qw, sw)
    assert torch.equal(_bits(y), _bits(yw))
    assert torch.equal(_bits(yv), _bits(yw))
    if n > 1024:  # what JAX gives
        assert torch.isnan(s[1]) and torch.isposinf(s[2:4]).all()
        assert not q[256:1024].any()


@pytest.fixture
def group(tmp_path):
    if dist.is_initialized():
        yield
        return
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bulk", "per_leaf", "partitioned"])
def test_train_step_launches_pack_per_plan(cuda_device, group, mode):
    cfg = get_smoke_config("llama3.2-1b").replace(param_dtype="float32")
    scfg = steps.StepConfig(sync_mode=mode, aggr_bytes=1 << 12,
                            param_dtype="float32", warmup_steps=1)
    batch = pipeline.for_model(cfg, 32, 2).batch(0)
    state = steps.build_state(cfg, 0, cuda_device)
    model = state["params"]
    leaves = [s for _, s in lm.param_leaves(model.named_parameters())]
    layer = [s for _, s in lm.param_leaves(model.layers[0]
                                           .named_parameters())]
    multi = lambda ls, aggr: sum(  # noqa: E731
        len(b.leaf_ids) > 1 for b in bucketing.make_plan(ls, aggr).buckets)
    if mode == "partitioned":
        rest = [s for n, s in lm.param_leaves(model.named_parameters())
                if not n.startswith("layers.")]
        want = cfg.n_layers * multi(layer, 1 << 12) + multi(rest, 1 << 12)
    else:
        want = multi(leaves, 256 << 20 if mode == "bulk" else 0)
    step = steps.make_train_step(cfg, scfg, seq_len=32, batch=2,
                                 device=cuda_device)
    before = dict(pbp.LAUNCHES)
    _, loss = step(state, steps.batch_to_device(batch, cuda_device))
    assert pbp.LAUNCHES["bucket_pack"] - before["bucket_pack"] == want
    assert pbp.LAUNCHES["bucket_unpack"] - before["bucket_unpack"] == want
    cpu = steps.build_state(cfg, 0, "cpu")
    with torch.no_grad():
        for (_, a), (_, b) in zip(cpu["params"].named_parameters(),
                                  steps.build_state(cfg, 0, cuda_device)
                                  ["params"].named_parameters()):
            a.copy_(b.cpu())
    cpu_step = steps.make_train_step(cfg, scfg, seq_len=32, batch=2,
                                     group=dist.new_group(backend="gloo"),
                                     device="cpu")
    _, cpu_loss = cpu_step(cpu, steps.batch_to_device(batch, "cpu"))
    np.testing.assert_allclose(loss.item(), cpu_loss.item(), rtol=1e-5)
