"""A configuration file's sizes, as the benchmark reads them.

``Sizes`` holds every number the weights, the traffic, the plain
references and the yardstick need, taken from the configuration file
alone (``configs/<name>.json``), never from the port.  A family names
how the published keys map onto them (``families/<family>.py``), and one
with numbers of its own subclasses ``Sizes``: a frozen dataclass whose
added fields have defaults.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Sizes:
    family: str
    name: str
    n_layers: int
    d_model: int
    vocab: int            # rows of the embedding, as run
    token_ids: int        # prompts and documents draw ids in [1, token_ids)
    tie: bool
    eps: float
    # GQA attention
    n_heads: int = 0
    n_kv: int = 0
    head_dim: int = 0
    rope_theta: float = 1e4
    attn_scale: float = 0.0
    # mixture of experts
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    min_capacity: int = 4
    dispatch_chunk: int = 4096
    # Mamba-2
    d_inner: int = 0
    m_heads: int = 0
    m_head_dim: int = 0
    d_state: int = 0
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 256


def load_config(name: str) -> dict:
    """``configs/<name>.json``."""
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def sizes(conf: dict) -> Sizes:
    """The sizes of a configuration file's model, as its family
    (``families/<family>.py``) maps the published keys onto them."""
    from .families import family
    return family(conf["family"]).sizes(conf)
