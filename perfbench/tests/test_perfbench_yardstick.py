"""The yardstick against hand-worked counts."""

import math
import types

import pytest

from perfbench import yardstick as y
from perfbench.harness import load_reader
from perfbench.sizes import load_config, sizes


@pytest.fixture(scope="module")
def granite():
    return sizes(load_config("granite-moe-3b-a800m"))


@pytest.fixture(scope="module")
def mamba():
    return sizes(load_config("mamba2-780m"))


def test_projection_weights(granite, mamba):
    # q, o: 1536 x 24 x 64 each; k, v: 1536 x 8 x 64 each; router
    # 1536 x 40; 8 experts of 3 x 1536 x 512
    attn = 2 * 1536 * 1536 + 2 * 1536 * 512
    assert y.proj_params(granite) == attn + 1536 * 40 + 8 * 3 * 1536 * 512
    # z, x: 1536 x 3072; B, C: 1536 x 128; dt: 1536 x 48; out 3072 x 1536
    assert y.proj_params(mamba) == 1536 * (2 * 3072 + 2 * 128 + 48) \
        + 3072 * 1536
    assert mamba.vocab == 50288 and mamba.token_ids == 50277


def test_train_and_prefill_flops(granite):
    t = 4 * 1024
    attn = 4 * 4 * 24 * 64 * (1024 * 1025 // 2)        # per layer
    fwd = 32 * (2 * y.proj_params(granite) * t + attn) \
        + 2 * 1536 * 49155 * t
    assert y.train_flops(granite, 4, 1024) == 3 * fwd
    pre = 32 * (2 * y.proj_params(granite) * t + attn) + 2 * 1536 * 49155 * 4
    assert y.prefill_flops(granite, 4, 1024) == pre


def test_ssd_flops(mamba):
    # 2 chunks of 256 and 100 more: causal pairs 2 * 32896 + 5050
    pairs = 2 * (256 * 257 // 2) + 100 * 101 // 2
    per_seq = 128 * pairs + 48 * 64 * pairs + 2 * 48 * 64 * 128 * 612
    assert y.mixer_flops(mamba, 3, 612) == 2 * 3 * per_seq


def test_flash_bound():
    # B 1, H 2, Hkv 1, S 4, D 8: FLOPs 4*1*2*8*10 = 640; bytes 2*4*8*6
    assert y.flash_bound_s(1, 2, 1, 4, 8) == max(640 / 989e12,
                                                 384 / 3.35e12)
    big = y.flash_bound_s(8, 24, 8, 8192, 64)
    assert math.isclose(big, 4 * 8 * 24 * 64 * (8192 * 8193 // 2) / 989e12)


def test_bucket_plan(granite, mamba):
    # a granite layer: wk, wo, wq, wv, ln1 + ln2 + router, w_down,
    # w_gate, w_up; then embed, final_norm; then the loss
    assert y.buckets([5, 1, 1, 9, 2, 2], 4) == [[5], [1, 1], [9], [2, 2]]
    packed = (1536 + 1536 + 1536 * 40) * 4
    assert y.step_sync(granite, 1 << 20) == (32 * 8 + 2 + 1, 32,
                                             32 * packed)
    assert y.step_sync(mamba, 1 << 20)[0] == 48 * 7 + 2 + 1
    assert y.pack_bound_s(1000) == 4000 / 3.35e12


def _run(s, mix, units, window_s, trace=None, counters=None, traced=None):
    """A run whose window served ``units`` and whose profile, after it,
    ``traced`` (the same units unless given)."""
    return types.SimpleNamespace(
        s=s, mix=mix, units=units, window_s=window_s, trace=trace,
        traced_units=units if traced is None else traced,
        counters=counters or {})


class _Trace:
    def __init__(self, times, window_s=1.0, busy_s=0.5):
        self.times, self.window_s, self.busy_s = times, window_s, busy_s

    def launches(self, match):
        return sum(1 for n, _ in self.times if match(n))

    def device_time_s(self, match):
        return sum(t for n, t in self.times if match(n))


def test_readers(granite, mamba):
    from perfbench.traffic.gen import load_mix
    tm, pm = load_mix("train_4x1024"), load_mix("prefill_pool")
    units = [{"batch": 4, "seq_len": 1024}] * 2
    r = _run(granite, tm, units, 2.0)
    assert load_reader("mfu.train")(r) == pytest.approx(
        100 * 2 * y.train_flops(granite, 4, 1024) / 2.0 / 67e12)
    # the rate of the window, not of the profiled steps after it
    assert load_reader("mfu.train")(_run(granite, tm, units, 2.0,
                                         traced=units[:1])) == \
        load_reader("mfu.train")(r)
    pu = [{"index": 0, "batch": 8, "len": 1024},
          {"index": 1, "batch": 8, "len": 8192}]
    r = _run(mamba, pm, pu, 3.0)
    want = (y.prefill_flops(mamba, 8, 1024) + y.prefill_flops(mamba, 8, 8192))
    assert load_reader("mfu.prefill")(r) == pytest.approx(
        100 * want / 3.0 / 989e12)
    _, n, nbytes = y.step_sync(granite, 1 << 20)
    tr = _Trace([("void bucket_kernel<1>", 1e-5)] * (2 * n * 2)
                + [("gemm", 1.0)])
    r = _run(granite, tm, units, 2.0, tr)
    assert load_reader("pack_roofline")(r) == pytest.approx(
        100 * y.pack_bound_s(2 * nbytes) / (4 * n * 1e-5))
    tr.times = tr.times[1:]           # a launch missing: nothing read
    assert load_reader("pack_roofline")(r) is None
    g = [{"index": 0, "batch": 8, "len": 2048}]
    tr = _Trace([("flash_wgmma_kernel", 1e-3)] * 32)
    r = _run(granite, pm, g, 1.0, tr)
    assert load_reader("flash_roofline")(r) == pytest.approx(
        100 * 32 * y.flash_bound_s(8, 24, 8, 2048, 64) / 0.032)
    assert load_reader("idle_share.train")(r) == pytest.approx(50.0)
    assert load_reader("idle_share.prefill")(_run(mamba, pm, g, 1.0)) \
        is None
    assert load_reader("sync_allreduces_per_step.train")(
        _run(granite, tm, units, 1.0, counters={
            "sync_allreduces_per_step": 259})) == 259
