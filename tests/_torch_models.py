"""Helpers shared by the port's model tests: Qwen2-VL grid positions
(the port's ``data.pipeline.grid_positions``), the data stream's
training batches of each architecture, and a one-rank gloo group for
the early-bird sync."""

import numpy as np
import pytest
import torch.distributed as dist

from repro.data import pipeline as jpipe
from repro_torch.data.pipeline import grid_positions  # noqa: F401


def seq_len(cfg) -> int:
    """Training sequence length of a smoke run: 32 tokens; the vision
    stub's 64 patches need more."""
    return 96 if cfg.frontend == "vision_stub" else 32


def stream_batches(cfg, n: int, batch: int = 2):
    """``n`` batches of the JAX data stream for ``cfg`` at
    :func:`seq_len`; the vision stub's get grid positions over its 64
    patches (a 1 x 8 x 8 grid), which the stream does not make."""
    s = seq_len(cfg)
    stream = jpipe.for_model(cfg, s, batch)
    out = []
    for i in range(n):
        b = stream.batch(i)
        if cfg.mrope_sections is not None:
            b["positions"] = grid_positions(batch, s, 1, 8, 8)
        out.append(b)
    return out


@pytest.fixture(scope="module", autouse=True)
def gloo_group(tmp_path_factory):
    """A one-rank gloo group for the module (the sync's all-reduces)."""
    if dist.is_initialized():
        yield
        return
    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
