"""ssd_share.prefill: the device busy time of the work launched inside
the Mamba-2 SSD scan's spans in the profiled prefills (``repro.ssd``,
``models.mamba.ssd_chunked``) over that launched inside
``repro.prefill`` (``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.device_share(run, ["repro.ssd"], "repro.prefill")
