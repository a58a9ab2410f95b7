"""ssd_roofline: the Mamba-2 SSD scan kernels' least time over the
profiled prefills (per layer and batch the larger of the scan's FLOPs,
``yardstick.mixer_flops``, at the bf16 peak and x, B, C and dt read once
and y written once at HBM bandwidth) over the device time of the
kernels named ``ssd_*``, read only when they launched the planned chain
of three kernels a layer a batch."""

import re

from perfbench import yardstick as y

KERNELS_PER_LAYER = 3   # chunk states, state pass, chunk scan
_SSD = re.compile(r"(^|[\s:])ssd_\w+")


def _ssd(name: str) -> bool:
    return _SSD.search(name) is not None


def bound_s(s, batch: int, n: int, elem_bytes: int) -> float:
    """The least time of one layer's scan over ``batch`` sequences of
    ``n``: x, B and C in the served dtype, dt in f32, y written once."""
    flops = y.mixer_flops(s, batch, n)
    tokens = batch * n
    nbytes = tokens * (elem_bytes * (2 * s.d_inner + 2 * s.n_groups
                                     * s.d_state) + 4 * s.m_heads)
    return max(flops / y.PEAK["bf16"], nbytes / y.PEAK["hbm"])


def read(run):
    s = run.s
    units = run.traced_units
    if run.trace is None or not units or s.family != "mamba2":
        return None
    if run.trace.launches(_ssd) != KERNELS_PER_LAYER * s.n_layers * len(units):
        return None
    t = run.trace.device_time_s(_ssd)
    elem = 2 if run.mix["param_dtype"] == "bfloat16" else 4
    bound = sum(s.n_layers * bound_s(s, u["batch"], u["len"], elem)
                for u in units)
    return 100.0 * bound / t if t > 0 else None
