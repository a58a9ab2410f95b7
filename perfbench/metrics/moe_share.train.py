"""moe_share.train: the device busy time of the work launched inside the
MoE's spans in the profiled training steps -- ``repro.moe`` with route,
experts and combine, their remat recomputations and backward spans --
over that launched inside ``repro.train_step`` (``perfbench/spans.py``
pairs the trace's launches with its device events)."""

from perfbench import spans


def read(run):
    return spans.device_share(run, ["repro.moe"], "repro.train_step")
