"""sync_allreduces_per_step.train: the all-reduces the early-bird sync
issued in a training step (``step_fn.log``, the port's SyncLog)."""


def read(run):
    return run.counters.get("sync_allreduces_per_step")
