"""Mamba-2: attention-free layers of the chunked SSD scan (plain
reference: ``reference/mamba2``)."""

from __future__ import annotations

from typing import List

from ..sizes import Sizes
from ..weights import Leaf, outer_leaves
from ..yardstick import causal_pairs


def sizes(conf: dict) -> Sizes:
    lay = conf["mamba2_layer_defaults"]
    d, mult = conf["d_model"], conf["pad_vocab_size_multiple"]
    di = lay["expand"] * d
    return Sizes(
        family=conf["family"], name=conf["name"], n_layers=conf["n_layer"],
        d_model=d, vocab=-(-conf["vocab_size"] // mult) * mult,
        token_ids=conf["vocab_size"], tie=conf["tie_embeddings"],
        eps=conf["assumed"]["rms_norm_eps"], d_inner=di,
        m_heads=di // lay["headdim"], m_head_dim=lay["headdim"],
        d_state=lay["d_state"], n_groups=lay["ngroups"],
        d_conv=lay["d_conv"], chunk=lay["chunk_size"])


def leaves(s: Sizes) -> List[Leaf]:
    L, d = s.n_layers, s.d_model
    di, nh, gn, k = s.d_inner, s.m_heads, s.n_groups * s.d_state, s.d_conv
    m = "layers.mamba."
    return outer_leaves(s) + [
        Leaf("layers.ln1", (L, d), "ones"),
        Leaf(m + "w_z", (L, d, di), "normal", d),
        Leaf(m + "w_x", (L, d, di), "normal", d),
        Leaf(m + "w_B", (L, d, gn), "normal", d),
        Leaf(m + "w_C", (L, d, gn), "normal", d),
        Leaf(m + "w_dt", (L, d, nh), "normal", d),
        Leaf(m + "conv_x", (L, k, di), "normal", k),
        Leaf(m + "conv_B", (L, k, gn), "normal", k),
        Leaf(m + "conv_C", (L, k, gn), "normal", k),
        Leaf(m + "conv_bx", (L, di), "zeros"),
        Leaf(m + "conv_bB", (L, gn), "zeros"),
        Leaf(m + "conv_bC", (L, gn), "zeros"),
        Leaf(m + "A_log", (L, nh), "a_log", 1, True),
        Leaf(m + "D", (L, nh), "ones", 1, True),
        Leaf(m + "dt_bias", (L, nh), "dt_bias", 1, True),
        Leaf(m + "norm", (L, di), "ones"),
        Leaf(m + "out_proj", (L, di, d), "normal", di)]


def port_config(s: Sizes, param_dtype: str):
    from repro_torch.models.lm import ModelConfig
    from repro_torch.models.mamba import MambaConfig
    return ModelConfig(
        name=s.name, n_layers=s.n_layers, d_model=s.d_model,
        vocab=s.vocab, d_ff=0, mixer="mamba", tie_embeddings=s.tie,
        param_dtype=param_dtype,
        mamba=MambaConfig(d_state=s.d_state, head_dim=s.m_head_dim,
                          n_groups=s.n_groups, d_conv=s.d_conv,
                          expand=s.d_inner // s.d_model, chunk=s.chunk))


def proj_params(s: Sizes, i: int) -> int:
    gn = s.n_groups * s.d_state
    d = s.d_model
    return d * (2 * s.d_inner + 2 * gn + s.m_heads) + s.d_inner * d


def mixer_flops(s: Sizes, i: int, batch: int, n: int) -> int:
    """The SSD terms at the chunk length, the intra-chunk ones over
    causal pairs."""
    q, h, p, N = s.chunk, s.m_heads, s.m_head_dim, s.d_state
    full, rest = divmod(n, q)
    pairs = full * causal_pairs(q) + causal_pairs(rest)
    intra = s.n_groups * N * pairs + h * p * pairs   # C.B^T, (L*CB).X
    states = 2 * h * p * N * n                       # B^T X, C.state
    return 2 * batch * (intra + states)


def kernels_ahead(s: Sizes, kind: str) -> List[str]:
    return {"train": ["bucket_pack"], "prefill": []}[kind]
