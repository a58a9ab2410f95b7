"""A configuration file's sizes, as the benchmark reads them.

``Sizes`` holds every number the weights, the traffic, the plain
references and the yardstick need, taken from the configuration file
alone (``configs/<name>.json``), never from the port.  A family names
how the published keys map onto them.
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
    """The sizes of a configuration file's model."""
    fam = conf["family"]
    if fam == "granite_moe":
        d, h = conf["hidden_size"], conf["num_attention_heads"]
        disp = conf["moe_dispatch"]
        return Sizes(
            family=fam, name=conf["name"],
            n_layers=conf["num_hidden_layers"], d_model=d,
            vocab=conf["vocab_size"], token_ids=conf["vocab_size"],
            tie=conf["tie_word_embeddings"], eps=conf["rms_norm_eps"],
            n_heads=h, n_kv=conf["num_key_value_heads"], head_dim=d // h,
            rope_theta=float(conf["rope_theta"]),
            attn_scale=conf["attention_multiplier"],
            n_experts=conf["num_local_experts"],
            top_k=conf["num_experts_per_tok"],
            d_expert=conf["intermediate_size"],
            capacity_factor=disp["capacity_factor"],
            min_capacity=disp["min_capacity"],
            dispatch_chunk=disp["dispatch_chunk"])
    if fam == "mamba2":
        lay = conf["mamba2_layer_defaults"]
        d, mult = conf["d_model"], conf["pad_vocab_size_multiple"]
        di = lay["expand"] * d
        return Sizes(
            family=fam, name=conf["name"], n_layers=conf["n_layer"],
            d_model=d, vocab=-(-conf["vocab_size"] // mult) * mult,
            token_ids=conf["vocab_size"], tie=conf["tie_embeddings"],
            eps=conf["assumed"]["rms_norm_eps"], d_inner=di,
            m_heads=di // lay["headdim"], m_head_dim=lay["headdim"],
            d_state=lay["d_state"], n_groups=lay["ngroups"],
            d_conv=lay["d_conv"], chunk=lay["chunk_size"])
    raise ValueError(f"unknown family {fam!r} in {conf.get('name')}")
