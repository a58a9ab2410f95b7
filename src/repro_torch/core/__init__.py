"""The simulator's main path: plan layer, rank topology, schedules and
drivers, and the fabric engines (``vector``/``reference`` on the host,
``torch`` and ``cuda`` on the device); and the training side's gradient
bucketing and early-bird sync (``bucketing``, ``earlybird``); the
partitioned ring collectives and partitioned-KV flash decode over a
``torch.distributed`` group (``chunked_collectives``, ``flash_decode``)."""
