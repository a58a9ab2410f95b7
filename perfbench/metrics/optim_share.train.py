"""optim_share.train: the device busy time of the work launched inside
the optimizer's span in the profiled training steps (``repro.optim``:
the AdamW update with its clip norm) over that launched inside
``repro.train_step`` (``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.device_share(run, ["repro.optim"], "repro.train_step")
