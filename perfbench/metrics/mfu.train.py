"""mfu.train: model FLOPs of the training steps of the measured window
(not the profiled steps after it) over the window's host-clock length,
as a share of the peak of the arithmetic the mix states
(``yardstick.compute_peak``): ``train_tokens_per_s`` times the FLOPs of
a token, over the peak."""

from perfbench import yardstick as y


def read(run):
    if not run.units or run.window_s <= 0:
        return None
    flops = sum(y.train_flops(run.s, u["batch"], u["seq_len"])
                for u in run.units)
    return 100.0 * flops / run.window_s / y.compute_peak(run.mix)
