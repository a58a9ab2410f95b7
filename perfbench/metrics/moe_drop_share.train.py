"""moe_drop_share.train: the MoE's routed slots past their expert's
capacity, dropped, as a share of all routed slots (the port's counters
``moe.dropped`` and ``moe.slots``) over the profiled training steps'
forward passes."""

from perfbench import spans


def read(run):
    return spans.count_share(run, "moe.dropped", "moe.slots")
