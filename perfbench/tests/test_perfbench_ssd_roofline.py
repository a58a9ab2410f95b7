"""ssd_roofline: the SSD scan kernels' bound over their device time,
read only where they launched three kernels a layer a batch."""

import types

import pytest

from perfbench import harness, yardstick
from perfbench.sizes import load_config, sizes

NAMES = ("void ssd_chunk_state_kernel<__nv_bfloat16>(__nv_bfloat16 const*)",
         "ssd_state_pass_kernel(float*, float const*)",
         "void ssd_chunk_scan_kernel<__nv_bfloat16>(__nv_bfloat16 const*)")
OTHER = "void at::native::elementwise_kernel<128, 2>(int)"


def _run(s, units, per_kernel_s=1e-3, launches=None, mix="bfloat16"):
    n = s.n_layers * len(units) if launches is None else launches
    kernels = [(0.0, per_kernel_s, name) for name in NAMES for _ in range(n)]
    kernels += [(0.0, 5.0, OTHER)] * 7

    def match_time(m):
        return sum(b - a for a, b, k in kernels if m(k))
    trace = types.SimpleNamespace(
        launches=lambda m: sum(1 for *_, k in kernels if m(k)),
        device_time_s=match_time)
    return types.SimpleNamespace(s=s, traced_units=units, trace=trace,
                                 mix={"param_dtype": mix})


@pytest.fixture
def mamba():
    return sizes(load_config("mamba2-780m"))


def test_reads_the_bound_over_the_ssd_kernels_time(mamba):
    read = harness.load_reader("ssd_roofline")
    units = [{"batch": 8, "len": 8192}, {"batch": 8, "len": 1024}]
    got = read(_run(mamba, units))
    t = 3 * mamba.n_layers * len(units) * 1e-3
    flops = sum(yardstick.mixer_flops(mamba, 8, n) for n in (8192, 1024))
    assert flops > 0
    bytes_8192 = 8 * 8192 * (2 * (2 * mamba.d_inner + 2 * mamba.d_state)
                             + 4 * mamba.m_heads)
    want = sum(max(yardstick.mixer_flops(mamba, 8, n) / yardstick.PEAK["bf16"],
                   bytes_8192 * n / 8192 / yardstick.PEAK["hbm"])
               for n in (8192, 1024))
    assert got == pytest.approx(100 * mamba.n_layers * want / t)
    # bytes bound at the served shape: 0.85 GB against 157 GFLOP
    assert bytes_8192 / yardstick.PEAK["hbm"] > \
        yardstick.mixer_flops(mamba, 8, 8192) / yardstick.PEAK["bf16"]


def test_reads_nothing_off_the_plan(mamba):
    read = harness.load_reader("ssd_roofline")
    units = [{"batch": 8, "len": 2048}]
    assert read(_run(mamba, units, launches=0)) is None      # the parent
    assert read(_run(mamba, units, launches=mamba.n_layers - 1)) is None
    assert read(_run(mamba, [])) is None
    run = _run(mamba, units)
    run.trace = None
    assert read(run) is None
    granite = sizes(load_config("granite-moe-3b-a800m"))
    assert read(_run(granite, units)) is None
