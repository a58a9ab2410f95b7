"""flash_roofline: the flash-attention kernel's least time over the
profiled prefills (per call the larger of its causal QK^T and PV
FLOPs at the bf16 peak and q, k, v read and o written once at HBM
bandwidth, ``yardstick.flash_bound_s``) over its device time, one call
a layer a batch."""

from perfbench import yardstick as y


def _flash(name: str) -> bool:
    return "flash_wgmma_kernel" in name or "flash_fwd_kernel" in name


def read(run):
    s = run.s
    units = run.traced_units
    if run.trace is None or not units or not s.n_heads:
        return None
    if run.trace.launches(_flash) != s.n_layers * len(units):
        return None
    t = run.trace.device_time_s(_flash)
    bound = sum(s.n_layers * y.flash_bound_s(u["batch"], s.n_heads, s.n_kv,
                                             u["len"], s.head_dim)
                for u in units)
    return 100.0 * bound / t if t > 0 else None
