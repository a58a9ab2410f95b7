"""Assigned input shapes (identical set for every LM-family architecture).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of ``seq_len``), not ``train_step``.  ``long_500k`` requires
sub-quadratic long-context handling and only runs for SSM/hybrid/local-attn
archs (see DESIGN.md §4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}

# Archs allowed to run long_500k (sub-quadratic long-context handling).
LONG_CONTEXT_ARCHS: Tuple[str, ...] = (
    "mamba2-780m",     # SSM: O(1) recurrent state
    "hymba-1.5b",      # hybrid: sliding window + SSM, 3 global layers
    "gemma2-9b",       # half the layers are sliding-window-local
)


def cells(arch_id: str):
    """The (shape) list applicable to one arch (skips documented in DESIGN)."""
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and arch_id not in LONG_CONTEXT_ARCHS:
            continue
        out.append(s)
    return out
