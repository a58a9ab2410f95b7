"""moe_share.prefill: the device busy time of the work launched inside
the MoE's spans in the profiled prefills (``repro.moe`` with route,
experts and combine) over that launched inside ``repro.prefill``
(``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.device_share(run, ["repro.moe"], "repro.prefill")
