"""Deterministic synthetic data pipeline, host-sharded and restartable.

Every batch is a pure function of (seed, step, host_index) — no state to
checkpoint, resume after preemption is exact, and elastic re-sharding only
changes the host partitioning of the same global stream.  Documents are
sampled with geometric lengths and packed with EOS separators to mimic a
real packed-LM pipeline.

The port's copy of the JAX package's ``data/pipeline.py``: NumPy only,
batch for batch the same arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_id: int = 0
    mean_doc_len: int = 512
    frontend: str = "tokens"     # tokens | audio_stub | vision_stub
    d_model: int = 0             # for embedding stubs
    n_patches: int = 64


class SyntheticStream:
    """Indexable synthetic stream: ``batch(step)`` is deterministic."""

    def __init__(self, cfg: DataConfig, host_index: int = 0,
                 host_count: int = 1):
        assert cfg.global_batch % host_count == 0, (
            cfg.global_batch, host_count)
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = cfg.global_batch // host_count

    def _rng(self, step: int, row: int) -> np.random.Generator:
        # Philox counter keyed on (seed, step, global row): reproducible
        # under any host partitioning.
        return np.random.Generator(np.random.Philox(
            key=self.cfg.seed, counter=[step, row, 0, 0]))

    def _row_tokens(self, step: int, grow: int) -> np.ndarray:
        cfg = self.cfg
        rng = self._rng(step, grow)
        out = np.empty(cfg.seq_len + 1, np.int32)
        pos = 0
        while pos < cfg.seq_len + 1:
            doc_len = 1 + rng.geometric(1.0 / cfg.mean_doc_len)
            n = min(doc_len, cfg.seq_len + 1 - pos)
            out[pos:pos + n] = rng.integers(1, cfg.vocab, size=n,
                                            dtype=np.int32)
            pos += n
            if pos < cfg.seq_len + 1:
                out[pos] = cfg.eos_id
                pos += 1
        return out

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rows = [self._row_tokens(step, self.host_index * self.local_batch + r)
                for r in range(self.local_batch)]
        seqs = np.stack(rows)                     # (B_local, S+1)
        batch: Dict[str, np.ndarray] = {
            "tokens": seqs[:, :-1],
            "labels": seqs[:, 1:].copy(),
        }
        if cfg.frontend == "audio_stub":
            rng = self._rng(step, 1 << 30)
            batch["embeds"] = rng.standard_normal(
                (self.local_batch, cfg.seq_len, cfg.d_model),
                dtype=np.float32)
            del batch["tokens"]
        elif cfg.frontend == "vision_stub":
            rng = self._rng(step, 1 << 30)
            batch["patch_embeds"] = rng.standard_normal(
                (self.local_batch, cfg.n_patches, cfg.d_model),
                dtype=np.float32)
        return batch

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def for_model(model_cfg, seq_len: int, global_batch: int, *, seed: int = 0,
              host_index: int = 0, host_count: int = 1) -> SyntheticStream:
    return SyntheticStream(
        DataConfig(vocab=model_cfg.vocab, seq_len=seq_len,
                   global_batch=global_batch, seed=seed,
                   frontend=model_cfg.frontend, d_model=model_cfg.d_model),
        host_index=host_index, host_count=host_count)


def grid_positions(b: int, s: int, t: int, h: int, w: int) -> np.ndarray:
    """Qwen2-VL M-RoPE positions (3, b, s) int32: a t x h x w patch grid
    first (rows temporal, height, width), then text whose three rows
    continue together after the grid's largest index.  The stream makes
    no positions; a batch with the vision stub's patches takes these."""
    n = t * h * w
    ti, hi, wi = np.meshgrid(np.arange(t), np.arange(h), np.arange(w),
                             indexing="ij")
    grid = np.stack([ti.ravel(), hi.ravel(), wi.ravel()])
    text = np.broadcast_to(np.arange(s - n) + grid.max() + 1, (3, s - n))
    pos = np.concatenate([grid, text], axis=1)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, b, s))
                                ).astype(np.int32)
