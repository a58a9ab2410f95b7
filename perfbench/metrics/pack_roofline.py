"""pack_roofline: the bucket pack and unpack kernels' least time (each
packed bucket's bytes read once and written once, by pack and again by
unpack, at HBM bandwidth) over their device time in the profiled steps.  The
buckets packed come from the yardstick's own copy of the greedy
aggregation; a trace whose launches disagree with it reads nothing."""

from perfbench import yardstick as y


def _bucket_kernel(name: str) -> bool:
    return "bucket_kernel" in name


def read(run):
    if run.trace is None or not run.traced_units:
        return None
    elem = 4 if run.mix["param_dtype"] == "float32" else 2
    _, n_packed, nbytes = y.step_sync(run.s, run.mix["aggr_bytes"], elem)
    steps = len(run.traced_units)
    if n_packed == 0 or \
            run.trace.launches(_bucket_kernel) != 2 * n_packed * steps:
        return None
    t = run.trace.device_time_s(_bucket_kernel)
    return 100.0 * y.pack_bound_s(nbytes * steps) / t if t > 0 else None
