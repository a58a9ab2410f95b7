"""The op-stream analysis of the port (``launch/op_analysis.py``), on the
subjects of ``tests/test_hlo_analysis.py``: FLOPs of the matmul-class
ops (2·m·n·k), equal to ``FlopCounterMode``'s; the HBM upper bound
(operands + outputs) and the lower bound (twice the outputs, data
movement left out); live bytes as the CUDA caching allocator counts
them; and the record keys of ``hlo_analysis.HloStats``.  Collective
bytes by dtype are held on a fake group in ``test_torch_dryrun.py``.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.launch import hlo_analysis
from repro_torch.launch import op_analysis as oa


def _run(fn, *shapes, dtype=torch.float32, fake=True):
    """``OpAnalysis`` of ``fn`` on tensors of ``shapes``."""
    ctx = FakeTensorMode() if fake else torch.no_grad()
    with ctx:
        args = [torch.empty(s, dtype=dtype) for s in shapes]
        with oa.OpAnalysis(args) as a:
            out = fn(*args)
    return a.stats, out


@pytest.mark.parametrize("case", [
    ("mm", lambda a, b: a @ b, (8, 16), (16, 4), 2 * 8 * 4 * 16),
    ("bmm", torch.bmm, (3, 8, 16), (3, 16, 4), 2 * 3 * 8 * 4 * 16),
    ("matmul", torch.matmul, (2, 3, 8, 16), (16, 4), 2 * 48 * 4 * 16),
    ("einsum", lambda a, b: torch.einsum("bsd,dv->bsv", a, b), (2, 8, 16),
     (16, 5), 2 * 16 * 5 * 16),
    ("addmm", lambda a, b: torch.addmm(b[0, :4], a, b[:, :4]), (8, 16),
     (16, 8), 2 * 8 * 4 * 16),
], ids=lambda c: c[0])
def test_dot_flops_are_2mnk(case):
    _, fn, sa, sb, want = case
    stats, _ = _run(fn, sa, sb)
    assert stats.dot_flops == want
    with FlopCounterMode(display=False) as fc:
        fn(torch.randn(sa), torch.randn(sb))
    assert fc.get_total_flops() == want


def test_flops_of_backward_equal_flop_counter():
    def fn(w, x):
        w.requires_grad_(True)
        loss = torch.tanh(x @ w).square().sum()
        loss.backward()
        return loss
    stats, _ = _run(fn, (16, 32), (8, 16))
    w, x = torch.randn(16, 32, requires_grad=True), torch.randn(8, 16)
    with FlopCounterMode(display=False) as fc:
        fn(w, x)
    # the forward product and the weight's gradient (x needs none)
    assert stats.dot_flops == fc.get_total_flops() == 2 * 2 * 8 * 32 * 16


@pytest.mark.parametrize("case", [
    ("cast", lambda x: x.to(torch.bfloat16), 4 * 64, 2 * 64),
    ("transpose+copy", lambda x: x.t().contiguous(), 4 * 64, 4 * 64),
    ("clone", lambda x: x.clone(), 4 * 64, 4 * 64),
    ("expand", lambda x: x[:1].expand(8, 16), 0, 0),
    ("reshape", lambda x: x.reshape(8, 8).view(64), 0, 0),
], ids=lambda c: c[0])
def test_data_movement_is_left_out_of_the_lower_bound(case):
    """Views move nothing; copies and casts read and write (the upper
    bound) but add nothing to the lower bound."""
    _, fn, read, written = case
    stats, _ = _run(fn, (4, 16))
    assert stats.hbm_bytes == read + written
    assert stats.hbm_bytes_min == 0


def test_compute_ops_count_twice_their_outputs():
    stats, _ = _run(lambda a, b: torch.exp(a + b), (4, 16), (4, 16))
    assert stats.hbm_bytes_min == 2 * (2 * 4 * 16 * 4)
    assert stats.hbm_bytes == (3 + 2) * 4 * 16 * 4
    assert 0 < stats.hbm_bytes_min <= stats.hbm_bytes


def test_live_bytes_follow_the_allocator():
    """Arguments, the peak of what the call makes and what it leaves
    alive, each storage rounded up to 512 bytes."""
    def fn(x):
        t = x * 2           # 4096 B
        u = t + 1           # 4096 B: peak 8192
        del t
        return u.sum()      # 4 B -> 512 B, alive at the end
    stats, out = _run(fn, (32, 32))
    assert stats.argument_bytes == 4096
    assert stats.peak_bytes == 4096 + 4096
    assert stats.output_bytes == 512
    assert oa.alloc_bytes(1) == oa.alloc_bytes(512) == 512
    assert oa.alloc_bytes(513) == 1024


def test_real_tensors_give_the_fake_ones_counts():
    fn = lambda a, b: torch.softmax(a @ b, -1).sum(0)  # noqa: E731
    fake, _ = _run(fn, (8, 16), (16, 4))
    real, _ = _run(fn, (8, 16), (16, 4), fake=False)
    assert fake.to_dict() == real.to_dict()
    assert (fake.peak_bytes, fake.output_bytes, fake.argument_bytes) == \
        (real.peak_bytes, real.output_bytes, real.argument_bytes)


def test_record_keys_are_hlo_stats_keys():
    stats, _ = _run(lambda a: a.sum(), (4,))
    assert set(stats.to_dict()) == set(hlo_analysis.HloStats().to_dict())
    assert oa.COLLECTIVES == hlo_analysis.COLLECTIVES
