"""The traffic generator: one for every mix, driven by the mix's file.

A mix is a data file ``traffic/<name>.json``; its ``kind`` picks the
generator below, and its numbers set it.  Every output is a pure
function of (seed, index), so that the plain reference can ask again for
what the timed path was given.

``train``: the packed-document stream of the port's data pipeline
(``data/pipeline.py``, copied here): each row of a step is documents of
geometric lengths (mean ``mean_doc_len``) of uniform ids, joined by
``eos_id``, keyed by a Philox counter on (seed, step, row).

``prefill_closed_loop``: ``clients`` prompts a batch, one length a
batch; the lengths come in cycles of batches, each cycle a seeded
permutation of ``cycle`` ([length, batches] pairs), so every whole cycle
holds the same share of each length; ids are uniform.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np

ROOT = Path(__file__).resolve().parent


def load_mix(name: str) -> dict:
    """``traffic/<name>.json``."""
    return json.loads((ROOT / f"{name}.json").read_text())


def _philox(seed: int, *counter: int) -> np.random.Generator:
    """A generator keyed on ``seed`` at the Philox counter ``counter``
    (up to four words, each below 2**63)."""
    c = np.array(list(counter) + [0] * (4 - len(counter)), dtype=np.uint64)
    return np.random.Generator(np.random.Philox(key=int(seed), counter=c))


class TrainStream:
    """``batch(step)``: {'tokens', 'labels'} (global_batch, seq_len)
    int32 NumPy arrays, the labels the tokens shifted by one."""

    def __init__(self, mix: dict, seed: int, token_ids: int):
        self.mix, self.seed, self.ids = mix, int(seed), int(token_ids)

    def _row(self, step: int, row: int) -> np.ndarray:
        mix = self.mix
        n_out = mix["seq_len"] + 1
        rng = _philox(self.seed, step, row)
        out = np.empty(n_out, np.int32)
        pos = 0
        while pos < n_out:
            doc = 1 + rng.geometric(1.0 / mix["mean_doc_len"])
            n = min(doc, n_out - pos)
            out[pos:pos + n] = rng.integers(1, self.ids, size=n,
                                            dtype=np.int32)
            pos += n
            if pos < n_out:
                out[pos] = mix["eos_id"]
                pos += 1
        return out

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rows = np.stack([self._row(step, r)
                         for r in range(self.mix["global_batch"])])
        return {"tokens": np.ascontiguousarray(rows[:, :-1]),
                "labels": np.ascontiguousarray(rows[:, 1:])}


class PrefillStream:
    """``length(i)`` and ``prompts(i)`` of batch ``i`` (0, 1, ...);
    negative ``i`` are the warm-up batches, one a length in ``lengths``
    order."""

    def __init__(self, mix: dict, seed: int, token_ids: int):
        self.mix, self.seed, self.ids = mix, int(seed), int(token_ids)
        self.cycle: List[int] = [int(n) for n, k in mix["cycle"]
                                 for _ in range(int(k))]
        self.lengths = sorted({int(n) for n, _ in mix["cycle"]})
        self._perm: Dict[int, np.ndarray] = {}

    def length(self, i: int) -> int:
        if i < 0:
            return self.lengths[(-i - 1) % len(self.lengths)]
        c, j = divmod(i, len(self.cycle))
        if c not in self._perm:
            self._perm[c] = _philox(self.seed, c, 0, 1).permutation(
                len(self.cycle))
        return self.cycle[self._perm[c][j]]

    def prompts(self, i: int) -> np.ndarray:
        """(clients, length(i)) int32 ids in [1, token_ids)."""
        rng = _philox(self.seed, i + len(self.lengths), 0, 2)
        return rng.integers(1, self.ids, size=(self.mix["clients"],
                                               self.length(i)),
                            dtype=np.int32)
