"""mfu.prefill: model FLOPs of the prefills of the measured window (not
the profiled batches after it) over the window's host-clock length, as
a share of the peak of the arithmetic the mix states (bf16)."""

from perfbench import yardstick as y


def read(run):
    if not run.units or run.window_s <= 0:
        return None
    flops = sum(y.prefill_flops(run.s, u["batch"], u["len"])
                for u in run.units)
    return 100.0 * flops / run.window_s / y.compute_peak(run.mix)
