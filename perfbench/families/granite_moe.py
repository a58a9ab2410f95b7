"""Granite-MoE: GQA attention with rotary positions and top-k routed
SwiGLU experts in every layer (plain reference: ``reference/granite_moe``)."""

from __future__ import annotations

from typing import Dict, List

from ..sizes import Sizes
from ..weights import Leaf, outer_leaves
from ..yardstick import causal_pairs


def sizes(conf: dict) -> Sizes:
    d, h = conf["hidden_size"], conf["num_attention_heads"]
    disp = conf["moe_dispatch"]
    return Sizes(
        family=conf["family"], name=conf["name"],
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


def leaves(s: Sizes) -> List[Leaf]:
    L, d = s.n_layers, s.d_model
    h, kv, hd, e, f = s.n_heads, s.n_kv, s.head_dim, s.n_experts, s.d_expert
    return outer_leaves(s) + [
        Leaf("layers.ln1", (L, d), "ones"),
        Leaf("layers.attn.wq", (L, d, h, hd), "normal", d),
        Leaf("layers.attn.wk", (L, d, kv, hd), "normal", d),
        Leaf("layers.attn.wv", (L, d, kv, hd), "normal", d),
        Leaf("layers.attn.wo", (L, h, hd, d), "normal", h * hd),
        Leaf("layers.ln2", (L, d), "ones"),
        Leaf("layers.moe.router", (L, d, e), "normal", d, True),
        Leaf("layers.moe.w_gate", (L, e, d, f), "normal", d),
        Leaf("layers.moe.w_up", (L, e, d, f), "normal", d),
        Leaf("layers.moe.w_down", (L, e, f, d), "normal", f)]


def port_config(s: Sizes, param_dtype: str):
    from repro_torch.models.lm import ModelConfig
    from repro_torch.models.moe import MoEConfig
    return ModelConfig(
        name=s.name, n_layers=s.n_layers, d_model=s.d_model,
        vocab=s.vocab, n_heads=s.n_heads, n_kv=s.n_kv, d_ff=0,
        rope_theta=s.rope_theta, tie_embeddings=s.tie,
        q_scale=s.attn_scale, param_dtype=param_dtype,
        moe=MoEConfig(n_experts=s.n_experts, top_k=s.top_k,
                      d_expert=s.d_expert,
                      capacity_factor=s.capacity_factor,
                      min_capacity=s.min_capacity,
                      dispatch_chunk=s.dispatch_chunk))


def proj_params(s: Sizes, i: int) -> int:
    d = s.d_model
    attn = d * s.n_heads * s.head_dim * 2 + 2 * d * s.n_kv * s.head_dim
    return attn + d * s.n_experts + s.top_k * 3 * d * s.d_expert


def mixer_flops(s: Sizes, i: int, batch: int, n: int) -> int:
    """QK^T and PV over the causal pairs."""
    return 4 * batch * s.n_heads * s.head_dim * causal_pairs(n)


def kernels_ahead(s: Sizes, kind: str) -> List[str]:
    return {"train": ["bucket_pack"], "prefill": ["flash_attention"]}[kind]


def calibrate_train(s: Sizes, seed: int, mix: dict, device
                    ) -> Dict[str, dict]:
    """``router_margins``: for the first checked batch through the plain
    reference's initial weights, how many (token, layer) routings have
    their ``top_k``-th and next router logits closer than 1e-6 and 1e-5,
    where rounding in another order of the same f32 sums can swap
    them."""
    import torch

    from .. import weights
    from ..reference import granite_moe as g
    from ..reference.common import at, rms_norm
    from ..traffic.gen import TrainStream
    W = {k: t.float() for k, t in weights.all_leaves(
        s, seed, device, getattr(torch, mix["param_dtype"])).items()}
    tok = torch.from_numpy(TrainStream(mix, seed, s.token_ids)
                           .batch(0)["tokens"]).to(device)
    out = {"1e-6": 0, "1e-5": 0, "min": float("inf")}
    with torch.no_grad():
        h = W["embed"][tok.long()]
        for i in range(s.n_layers):
            h = h + g.attention(s, W, i, rms_norm(
                h, at(s, W, "layers.ln1", i), s.eps), "f32")
            x = rms_norm(h, at(s, W, "layers.ln2", i), s.eps)
            v = torch.topk(x.reshape(-1, s.d_model)
                           @ at(s, W, "layers.moe.router", i),
                           s.top_k + 1).values
            m = v[:, s.top_k - 1] - v[:, s.top_k]
            out["1e-6"] += int((m < 1e-6).sum())
            out["1e-5"] += int((m < 1e-5).sum())
            out["min"] = min(out["min"], float(m.min()))
            h = h + g.moe(s, W, i, x, "f32")
    del W
    return {"router_margins": out}
