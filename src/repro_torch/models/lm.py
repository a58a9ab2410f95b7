"""Language model: config, init, forward, loss, prefill and decode.

The port's counterpart of the JAX package's ``models/lm.py``.  One
``ModelConfig`` (field for field the reference's, with copies of
``MoEConfig`` (``models/moe.py``), ``MambaConfig`` (``models/mamba.py``)
and ``MLAConfig``) describes every architecture: dense GQA (llama,
gemma, qwen), M-RoPE with the vision stub (qwen2-vl), the audio stub
(musicgen), MLA (minicpm3), Mamba-2 (mamba2), MoE (granite-moe,
moonshot) and the Hymba hybrid.  The stub frontends take precomputed
embeddings: musicgen's frame embeddings replace the token lookup, and
qwen2-vl's patch embeddings overwrite the first token embeddings.
Parameters live in an :class:`LM` module whose per-layer blocks
sit in an ``nn.ModuleList`` instead of the stacked L axis; their shapes
and names are the JAX package's, so weights carry over by a copy
(``models/convert.py``), and :func:`param_leaves` lists them in the order
of JAX's flattened parameter tree.  The decode cache is a dict of
preallocated tensors stacked on a leading L axis in the JAX layout,
written in place.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from ..core.fabric_torch import resolve_device
from ..launch.mesh import PartitionSpec as P
from . import tp as tpc
from .attention import MLA, head_to_kv_map, init_attention, init_mla
from .blocks import Block, block_fwd
from .layers import chunked_cross_entropy, dense_init, embed_init, rms_norm, \
    softcap
from .mamba import F32_LEAVES as _MAMBA_F32
from .mamba import MambaConfig, init_mamba, mamba_cache_shapes
from .moe import MoEConfig, init_moe

# Parameters the JAX package keeps in f32 whatever the parameter dtype:
# the MoE router and the Mamba decay, skip and step-bias vectors.
F32_LEAVES = ("router", *_MAMBA_F32)


@dataclass(frozen=True)
class MLAConfig:
    q_lora: int = 768
    kv_lora: int = 256
    qk_nope: int = 64
    qk_rope: int = 32
    v_dim: int = 64


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0            # 0 for attention-free archs
    n_kv: int = 0
    d_ff: int = 0               # dense FFN hidden; 0 = no FFN (mamba2)
    head_dim: int = 0           # 0 -> d_model // n_heads
    mixer: str = "attn"         # attn | mamba | hybrid
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_theta: float = 1e4
    mrope_sections: Optional[Tuple[int, int, int]] = None
    # per-layer windows: "global" | "gemma_alt" | "hymba"
    window_pattern: str = "global"
    window_size: int = 0
    post_norm: bool = False
    tie_embeddings: bool = False
    zero_centered_norm: bool = False
    emb_scale: bool = False     # gemma: embeddings scaled by sqrt(d_model)
    frontend: str = "tokens"    # tokens | audio_stub | vision_stub
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    q_scale: Optional[float] = None
    q_chunk: int = 512
    loss_chunk: int = 512
    tp_pad: int = 1             # pad heads/experts to a multiple of this
    param_dtype: str = "float32"

    # ---- derived ----
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def n_heads_padded(self) -> int:
        if self.n_heads == 0:
            return 0
        return -(-self.n_heads // self.tp_pad) * self.tp_pad

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up for TP sharding; padded logits are masked to
        -inf so semantics match the logical vocab exactly."""
        return -(-self.vocab // self.tp_pad) * self.tp_pad

    @property
    def head_map(self) -> Tuple[int, ...]:
        return head_to_kv_map(self.n_heads, self.n_kv, self.n_heads_padded)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def windows(self) -> Tuple[int, ...]:
        L = self.n_layers
        if self.window_pattern == "global":
            return (0,) * L
        if self.window_pattern == "gemma_alt":  # local on even layers
            return tuple(self.window_size if i % 2 == 0 else 0
                         for i in range(L))
        if self.window_pattern == "hymba":  # global at first/middle/last
            g = {0, L // 2, L - 1}
            return tuple(0 if i in g else self.window_size for i in range(L))
        raise ValueError(self.window_pattern)

    def with_tp(self, tp: int) -> "ModelConfig":
        """Return a copy padded for a TP degree (heads + experts)."""
        moe = self.moe
        if moe is not None:
            epad = -(-moe.n_experts // tp) * tp
            moe = dataclasses.replace(moe, n_experts_padded=epad)
        return dataclasses.replace(self, tp_pad=tp, moe=moe)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (logical, for MODEL_FLOPS) ----
    def param_count(self, padded: bool = False) -> int:
        nh = self.n_heads_padded if padded else self.n_heads
        hd = self.head_dim_
        d = self.d_model
        vv = self.vocab_padded if padded else self.vocab
        n = vv * d  # embed
        if not self.tie_embeddings:
            n += d * vv
        per_layer = 0
        if self.mixer in ("attn", "hybrid"):
            if self.mla is not None:
                m = self.mla
                per_layer += (d * m.q_lora
                              + m.q_lora * nh * (m.qk_nope + m.qk_rope)
                              + d * m.kv_lora + m.kv_lora * nh * m.qk_nope
                              + m.kv_lora * nh * m.v_dim + d * m.qk_rope
                              + nh * m.v_dim * d)
            else:
                per_layer += (d * nh * hd + 2 * d * self.n_kv * hd
                              + nh * hd * d)
        if self.mixer in ("mamba", "hybrid"):
            mc = self.mamba
            di = mc.d_inner(d)
            gn = mc.n_groups * mc.d_state
            per_layer += 2 * d * di + 2 * d * gn + d * mc.n_heads(d) + di * d
        if self.moe is not None:
            e = self.moe.e_pad if padded else self.moe.n_experts
            per_layer += d * e + e * 3 * d * self.moe.d_expert
        elif self.d_ff > 0:
            per_layer += 3 * d * self.d_ff
        return n + self.n_layers * per_layer

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        all_experts = self.n_layers * self.moe.n_experts * 3 * self.d_model \
            * self.moe.d_expert
        active = self.n_layers * self.moe.top_k * 3 * self.d_model \
            * self.moe.d_expert
        return full - all_experts + active


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class LM(nn.Module):
    """The parameters of a language model, allocated uninitialised on
    ``device`` in ``dtype`` (default: the config's; the
    :data:`F32_LEAVES` are always f32): ``embed`` (V, d), ``final_norm``
    (d,), ``head`` (d, V) unless tied, and ``layers``, one
    :class:`Block` per layer.  No parameter requires a gradient until
    training asks for it (``requires_grad_()``)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype=None):
        super().__init__()
        dt = cfg.dtype if dtype is None else dtype
        d, vp = cfg.d_model, cfg.vocab_padded

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                requires_grad=False)
        self.cfg = cfg
        self.embed = p(vp, d)
        self.final_norm = p(d)
        if not cfg.tie_embeddings:
            self.head = p(d, vp)
        self.layers = nn.ModuleList(
            Block(cfg, dtype=dt, device=device) for _ in range(cfg.n_layers))


@torch.no_grad()
def cast(model: LM, dtype: torch.dtype) -> LM:
    """Cast ``model``'s parameters to ``dtype`` in place, all but the
    :data:`F32_LEAVES` (what ``init_params`` in ``dtype`` would give from
    the same draws, as every draw is made in f32)."""
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] not in F32_LEAVES:
            p.data = p.data.to(dtype)
    return model


def param_leaves(named: Iterable[Tuple[str, torch.Tensor]]
                 ) -> List[Tuple[str, List[torch.Tensor]]]:
    """The leaves of the JAX package's parameter tree, in its flattening
    order (dict keys sorted at every level), from port names and
    tensors: ``(name, segments)`` where the per-layer tensors
    ``layers.<i>.<rest>`` form one leaf ``layers.<rest>`` whose segments
    are the layers in order -- the slices of JAX's stacked array."""
    groups: Dict[str, list] = {}
    for name, t in named:
        parts = name.split(".")
        if parts[0] == "layers" and len(parts) > 2 and parts[1].isdigit():
            key = ".".join(["layers", *parts[2:]])
            groups.setdefault(key, []).append((int(parts[1]), t))
        else:
            groups[name] = [(0, t)]
    return [(k, [t for _, t in sorted(v, key=lambda it: it[0])])
            for k, v in sorted(groups.items(),
                               key=lambda kv: tuple(kv[0].split(".")))]


def _norm_init(cfg: ModelConfig, w: torch.Tensor) -> None:
    """Unit norm scale, or zero where the norm uses ``1 + scale``."""
    if cfg.zero_centered_norm:
        w.zero_()
    else:
        w.fill_(1.0)


@torch.no_grad()
def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device="cuda", dtype=None) -> LM:
    """A model of ``cfg`` on ``device``, its weights drawn from ``gen``
    (a ``torch.Generator`` on the same device) in f32 and cast to
    ``dtype`` (default: the parameter dtype; the :data:`F32_LEAVES` stay
    f32), with the JAX package's initialisers: fan-in truncated normals,
    ``1/sqrt(d)`` embeddings, unit (or zero-centred zero) norms, zero
    biases, the Mamba leaves of ``init_mamba``, zeroed padding rows,
    head slots and expert slots."""
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"init_params: generator on {gen.device}, model"
                         f" on {dev}")
    model = LM(cfg, device=dev, dtype=dtype)
    dt, d = model.embed.dtype, cfg.d_model
    model.embed.copy_(embed_init(gen, cfg.vocab_padded, d, dt))
    model.embed[cfg.vocab:].zero_()
    _norm_init(cfg, model.final_norm)
    if not cfg.tie_embeddings:
        model.head.copy_(dense_init(gen, d, (cfg.vocab_padded,), dt))
        model.head[:, cfg.vocab:].zero_()
    for lp in model.layers:
        _norm_init(cfg, lp.ln1)
        if isinstance(getattr(lp, "attn", None), MLA):
            init_mla(lp.attn, gen, n_heads=cfg.n_heads)
        elif hasattr(lp, "attn"):
            init_attention(lp.attn, gen, n_heads=cfg.n_heads)
        if hasattr(lp, "mamba"):
            init_mamba(lp.mamba, gen)
        if cfg.mixer == "hybrid":
            lp.norm_attn.fill_(1.0)
            lp.norm_mamba.fill_(1.0)
        if cfg.post_norm:
            _norm_init(cfg, lp.ln1_post)
        if cfg.moe is not None or cfg.d_ff > 0:
            _norm_init(cfg, lp.ln2)
            if cfg.moe is not None:
                init_moe(lp.moe, gen, cfg.moe)
            else:
                lp.mlp.w_gate.copy_(dense_init(gen, d, (cfg.d_ff,), dt))
                lp.mlp.w_up.copy_(dense_init(gen, d, (cfg.d_ff,), dt))
                lp.mlp.w_down.copy_(dense_init(gen, cfg.d_ff, (d,), dt))
            if cfg.post_norm:
                _norm_init(cfg, lp.ln2_post)
    return model


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device="cuda") -> Dict[str, torch.Tensor]:
    """Zeroed decode cache in ``dtype`` (default: the parameter dtype),
    stacked on a leading L axis in the JAX layout: attention {'k', 'v'}
    (L, batch, max_len, n_kv, head_dim); MLA {'ckv'} (L, batch, max_len,
    kv_lora) and {'kr'} (L, batch, max_len, qk_rope); Mamba {'state'}
    (L, batch, H, P, N) and {'conv_x', 'conv_B', 'conv_C'} (L, batch,
    d_conv - 1, C).  The hybrid holds both attention and Mamba."""
    dt = cfg.dtype if dtype is None else dtype
    if isinstance(dt, str):
        dt = getattr(torch, dt)
    dev = resolve_device(device)
    return {k: torch.zeros(s, dtype=dt, device=dev)
            for k, s in cache_shapes(cfg, batch, max_len).items()}


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int
                 ) -> Dict[str, Tuple[int, ...]]:
    """The shape of each entry of :func:`init_cache`."""
    L = cfg.n_layers
    shapes: Dict[str, Tuple[int, ...]] = {}
    if cfg.mixer in ("attn", "hybrid"):
        if cfg.mla is not None:
            shapes["ckv"] = (L, batch, max_len, cfg.mla.kv_lora)
            shapes["kr"] = (L, batch, max_len, cfg.mla.qk_rope)
        else:
            shapes["k"] = shapes["v"] = (L, batch, max_len, cfg.n_kv,
                                         cfg.head_dim_)
    if cfg.mixer in ("mamba", "hybrid"):
        for k, v in mamba_cache_shapes(batch, cfg.d_model,
                                       cfg.mamba).items():
            shapes[k] = (L, *v)
    return shapes


# ---------------------------------------------------------------------------
# Sharding specs (model/TP axis only; DP handled by the caller)
# ---------------------------------------------------------------------------

MODEL_AXIS = "model"


def _dotted(tree: Dict, prefix: str = "") -> Dict[str, object]:
    """A nested dict flattened to dotted names (``layers.attn.wq``)."""
    out: Dict[str, object] = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_dotted(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


@functools.lru_cache(maxsize=128)
def _named_shapes(cfg: ModelConfig) -> Tuple[Tuple[str, torch.Size], ...]:
    """Each parameter's port name and shape, from a model built on the
    meta device once a config."""
    return tuple((name, p.shape) for name, p in
                 LM(cfg, device=torch.device("meta")).named_parameters())


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """The shape of every leaf of the JAX package's parameter tree, by
    the port's leaf name (:func:`param_leaves`: ``layers.<rest>`` for the
    per-layer parameters stacked on a leading L axis), in its order.
    Nothing is allocated (the model is built on the meta device)."""
    return {name: ((len(segs), *segs[0]) if name.startswith("layers.")
                   else tuple(segs[0]))
            for name, segs in param_leaves(_named_shapes(cfg))}


def param_specs(cfg: ModelConfig, axis: str = MODEL_AXIS) -> Dict[str, P]:
    """The JAX package's ``PartitionSpec`` of every parameter leaf (the
    tensor-parallel split over ``axis``), by the port's leaf name, as
    :func:`param_shapes`; the stacked layer axis is never split."""
    A = axis

    def attn_specs():
        if cfg.mla is not None:
            return {
                "w_dq": P(None, None, None), "norm_q": P(None, None),
                "w_uq": P(None, None, A, None),
                "w_dkv": P(None, None, None), "norm_kv": P(None, None),
                "w_uk": P(None, None, A, None),
                "w_uv": P(None, None, A, None),
                "w_kr": P(None, None, None),
                "wo": P(None, A, None, None),
            }
        s = {
            "wq": P(None, None, A, None),
            "wk": P(None, None, None, None),
            "wv": P(None, None, None, None),
            "wo": P(None, A, None, None),
        }
        if cfg.qkv_bias:
            s.update({"bq": P(None, A, None), "bk": P(None, None, None),
                      "bv": P(None, None, None)})
        return s

    def mamba_specs():
        return {
            "w_z": P(None, None, A), "w_x": P(None, None, A),
            "w_B": P(None, None, None), "w_C": P(None, None, None),
            "w_dt": P(None, None, None),
            "conv_x": P(None, None, A), "conv_B": P(None, None, None),
            "conv_C": P(None, None, None),
            "conv_bx": P(None, A), "conv_bB": P(None, None),
            "conv_bC": P(None, None),
            "A_log": P(None, None), "D": P(None, None),
            "dt_bias": P(None, None),
            "norm": P(None, A), "out_proj": P(None, A, None),
        }

    lp: Dict[str, object] = {"ln1": P(None, None)}
    if cfg.mixer in ("attn", "hybrid"):
        lp["attn"] = attn_specs()
    if cfg.mixer in ("mamba", "hybrid"):
        lp["mamba"] = mamba_specs()
    if cfg.mixer == "hybrid":
        lp["norm_attn"] = P(None, None)
        lp["norm_mamba"] = P(None, None)
    if cfg.post_norm:
        lp["ln1_post"] = P(None, None)
    if cfg.moe is not None or cfg.d_ff > 0:
        lp["ln2"] = P(None, None)
        if cfg.moe is not None:
            lp["moe"] = {
                "router": P(None, None, None),
                "w_gate": P(None, A, None, None),
                "w_up": P(None, A, None, None),
                "w_down": P(None, A, None, None),
            }
        else:
            lp["mlp"] = {"w_gate": P(None, None, A), "w_up": P(None, None, A),
                         "w_down": P(None, A, None)}
        if cfg.post_norm:
            lp["ln2_post"] = P(None, None)

    specs: Dict[str, object] = {
        "embed": P(A, None),
        "final_norm": P(None),
        "layers": lp,
    }
    if not cfg.tie_embeddings:
        specs["head"] = P(None, A)
    flat = _dotted(specs)
    return {name: flat[name] for name in param_shapes(cfg)}


def _units(cfg: ModelConfig, name: str, shape, spec) -> Dict[int, int]:
    """The unit of each split dim of a leaf: a Mamba head's channels for
    the d_inner dims of the Mamba leaves (so that a rank's block holds
    whole heads), else 1."""
    if not name.startswith("layers.mamba.") or cfg.mamba is None:
        return {}
    di = cfg.mamba.d_inner(cfg.d_model)
    return {d: cfg.mamba.head_dim for d, e in enumerate(tuple(spec))
            if e is not None and shape[d] == di}


def param_units(cfg: ModelConfig, axis: str = MODEL_AXIS
                ) -> Dict[str, Dict[int, int]]:
    """The unit of each split dim of every leaf (:func:`_units`: a Mamba
    head's channels on the d_inner dims, else 1), by leaf name; the
    ``units`` of ``launch.mesh.local_slices`` for the blocks of
    :func:`param_blocks`, and of the ZeRO-1 moments laid over them."""
    shapes, specs = param_shapes(cfg), param_specs(cfg, axis)
    return {k: _units(cfg, k, shapes[k], specs[k]) for k in shapes}


# The norms on the residual stream (not inside a mixer): under sequence
# parallelism each rank normalises only its block of the sequence.
STREAM_NORMS = ("final_norm", "layers.ln1", "layers.ln2", "layers.ln1_post",
                "layers.ln2_post", "layers.norm_attn", "layers.norm_mamba")


def partial_grad_leaves(cfg: ModelConfig, seq_split: bool,
                        axis: str = MODEL_AXIS) -> Tuple[str, ...]:
    """The leaves whose gradient on a tensor-parallel rank is only a
    partial sum over ``axis`` -- what GSPMD sums in the JAX package: the
    replicated leaves read inside a tensor-parallel region (GQA's
    ``wk``/``wv``/``bk``/``bv``, each rank using the KV heads its q heads
    need; MLA's latent projections and their norms; Mamba's B/C/dt
    projections and convolutions, and ``A_log``, ``D``, ``dt_bias`` of
    which a rank reads its heads; the MoE router, whose slots of experts
    held elsewhere are zero-weighted), and with ``seq_split`` the
    :data:`STREAM_NORMS`, which then see one block of the sequence.  The
    split leaves (their gradients are their blocks') and, without
    ``seq_split``, the stream norms (read where the stream is whole on
    every rank) are not listed."""
    return tuple(name for name, spec in param_specs(cfg, axis).items()
                 if axis not in tuple(spec)
                 and (seq_split or name not in STREAM_NORMS))


def param_blocks(cfg: ModelConfig, mesh, axis: str = MODEL_AXIS
                 ) -> Dict[str, Tuple[slice, ...]]:
    """This rank's block of every parameter leaf on ``mesh`` under
    :func:`param_specs` (``launch.mesh.local_slices``), by leaf name,
    over the stacked shapes of :func:`param_shapes`.  A split dim that
    does not divide over the axis takes ``launch.mesh.block``'s rule,
    the d_inner dims of the Mamba leaves in whole heads."""
    from ..launch.mesh import local_slices
    shapes, specs = param_shapes(cfg), param_specs(cfg, axis)
    units = param_units(cfg, axis)
    return {k: local_slices(shapes[k], specs[k], mesh, units=units[k])
            for k in shapes}


def local_shapes(cfg: ModelConfig, blocks: Dict[str, Tuple[slice, ...]]
                 ) -> Dict[str, Tuple[int, ...]]:
    """Each parameter's shape (by port name, ``layers.<i>.<rest>``) in a
    model holding ``blocks`` (:func:`param_blocks`)."""
    out = {}
    for name, _ in _named_shapes(cfg):
        parts = name.split(".")
        layer = parts[0] == "layers"
        leaf = ".".join(["layers", *parts[2:]]) if layer else name
        sl = blocks[leaf][1:] if layer else blocks[leaf]
        out[name] = tuple(s.stop - s.start for s in sl)
    return out


def local_model(cfg: ModelConfig, blocks: Dict[str, Tuple[slice, ...]], *,
                device, dtype=None) -> LM:
    """An uninitialised :class:`LM` holding this rank's ``blocks`` of
    every leaf (:func:`param_blocks`): the model a tensor-parallel step
    takes (``models.convert.tp_params_from_jax`` and
    ``tp_shard_model`` fill it)."""
    model = LM(cfg, device=torch.device("meta"), dtype=dtype)
    shapes = local_shapes(cfg, blocks)
    for name, p in list(model.named_parameters()):
        mod, _, attr = name.rpartition(".")
        setattr(model.get_submodule(mod) if mod else model, attr,
                nn.Parameter(torch.empty(shapes[name], dtype=p.dtype,
                                         device=device),
                             requires_grad=False))
    return model


def cache_specs(cfg: ModelConfig, axis: str = MODEL_AXIS,
                data_axis=None, seq_axis=None) -> Dict[str, P]:
    """Sharding specs of the decode cache (:func:`init_cache`'s entries):
    batch over ``data_axis``, sequence over ``seq_axis``; the Mamba
    state's heads and the convolution tail's channels over ``axis``."""
    c: Dict[str, P] = {}
    if cfg.mixer in ("attn", "hybrid"):
        if cfg.mla is not None:
            c["ckv"] = P(None, data_axis, seq_axis, None)
            c["kr"] = P(None, data_axis, seq_axis, None)
        else:
            c["k"] = P(None, data_axis, seq_axis, None, None)
            c["v"] = P(None, data_axis, seq_axis, None, None)
    if cfg.mixer in ("mamba", "hybrid"):
        c["state"] = P(None, data_axis, axis, None, None)
        c["conv_x"] = P(None, data_axis, None, axis)
        c["conv_B"] = P(None, data_axis, None, None)
        c["conv_C"] = P(None, data_axis, None, None)
    return c


# ---------------------------------------------------------------------------
# Forward / prefill / decode
# ---------------------------------------------------------------------------

def input_key(cfg: ModelConfig) -> str:
    """The batch entry that carries the model's input: ``embeds`` (B, S,
    d) for the audio stub, whose EnCodec frontend is a stub that takes
    precomputed frame embeddings, else ``tokens`` (B, S)."""
    return "embeds" if cfg.frontend == "audio_stub" else "tokens"


def input_batch(cfg: ModelConfig, x: torch.Tensor, **extra) -> Dict:
    """A batch with ``x`` under :func:`input_key` and each of ``extra``
    (``patch_embeds``, ``positions``, ``labels``) that is not None."""
    return {input_key(cfg): x,
            **{k: v for k, v in extra.items() if v is not None}}


def _model_input(cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    key = input_key(cfg)
    if key not in batch:
        shape = "(B, S, d), not tokens" if key == "embeds" else "(B, S)"
        raise KeyError(f"{cfg.name}: the model takes batch[{key!r}] {shape}")
    return batch[key]


def _decode_batch(cfg: ModelConfig, tokens: Optional[torch.Tensor],
                  embeds: Optional[torch.Tensor]) -> Dict:
    """The one-position batch of a decode step: the audio stub's
    ``embeds`` (B, 1, d) (its ``tokens``, if any, unread, as in JAX),
    else ``tokens`` (B,).  Raises ``ValueError`` when that input is
    missing, or for ``embeds`` given to a model that reads tokens."""
    key = input_key(cfg)
    x = embeds if key == "embeds" else tokens
    if x is None:
        raise ValueError(f"{cfg.name}: a decode step takes {key}"
                         f" {'(B, 1, d)' if key == 'embeds' else '(B,)'}")
    if key == "tokens" and embeds is not None:
        raise ValueError(f"{cfg.name}: embeds are the audio stub's input;"
                         f" this model decodes tokens")
    return {key: x if key == "embeds" else x[:, None]}


def _embed_inputs(cfg: ModelConfig, params: LM, batch: Dict,
                  tp=None, seq_split: bool = False) -> torch.Tensor:
    """The input embeddings (B, S, d); with ``seq_split`` this rank's
    (B, S/M, d) block of the sequence.  Under ``tp`` the lookup is
    vocab-parallel: each rank looks up the tokens of its vocabulary
    block (the others give zeros), and the blocks' sum is all-reduced,
    or reduce-scattered along the sequence with ``seq_split``."""
    x = _model_input(cfg, batch)
    if cfg.frontend == "audio_stub":
        # musicgen: precomputed frame embeddings come straight in
        h = x.to(cfg.dtype)
        return _seq_block(h, tp) if seq_split else h
    if tp is None:
        h = params.embed[x.long()]
    else:
        rows = params.embed.shape[0]
        ids = x.long() - tp.rank * rows
        mine = (ids >= 0) & (ids < rows)
        h = params.embed[ids.clamp(0, rows - 1)]
        h = tpc.reduce_out(torch.where(mine[..., None], h, 0), tp, seq_split)
    if cfg.emb_scale:  # the scale is rounded to the parameter dtype first
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype,
                             device=h.device)
    if cfg.frontend == "vision_stub" and "patch_embeds" in batch:
        # the patches overwrite the first token embeddings; a patch block
        # larger than the stream raises, as JAX's dynamic_update_slice
        pe = batch["patch_embeds"]
        full = (h.shape[0], x.shape[1], h.shape[2])
        if pe.dim() != h.dim() or any(a > b for a, b in zip(pe.shape,
                                                              full)):
            raise ValueError(f"{cfg.name}: patch_embeds {tuple(pe.shape)}"
                             f" do not fit the token embeddings {full}")
        off = tp.rank * h.shape[1] if seq_split else 0
        n = max(0, min(pe.shape[1] - off, h.shape[1]))
        if tp is not None:  # a collective's output may be a view of it
            h = h.clone()
        h[:pe.shape[0], :n, :pe.shape[2]] = pe[:, off:off + n].to(h.dtype)
    return h


def _seq_block(h: torch.Tensor, tp) -> torch.Tensor:
    """This rank's block of the sequence (dim 1)."""
    n = h.shape[1] // tp.size
    return h[:, tp.rank * n:(tp.rank + 1) * n]


def _positions(cfg: ModelConfig, batch: Dict, b: int, s: int,
               cache_pos: Optional[int], device) -> torch.Tensor:
    """Explicit ``batch['positions']`` as given; else decode's write
    offset (B, 1), or ``arange(S)``.  Under M-RoPE the three rows are
    equal: (3, B, 1) in decode, (3, S) otherwise -- JAX's (3, B, S)
    broadcast over the batch, whose temporal row stays 1-D, so a prefill
    keeps the flash kernel's causal mask."""
    if "positions" in batch:
        return batch["positions"]
    mrope = cfg.mrope_sections is not None
    if cache_pos is not None and s == 1:  # decode
        pos = torch.full((b, 1), cache_pos, dtype=torch.int32,
                         device=device)
        return pos.expand(3, b, 1) if mrope else pos
    pos = torch.arange(s, dtype=torch.int32, device=device)
    return pos.expand(3, s) if mrope else pos


def unread_params(cfg: ModelConfig) -> Tuple[str, ...]:
    """Parameters the loss never reads, whose gradient JAX gives as
    zeros: the audio stub takes frame embeddings, so ``embed`` is unread
    unless it is also the (tied) head."""
    if cfg.frontend == "audio_stub" and not cfg.tie_embeddings:
        return ("embed",)
    return ()


def forward(cfg: ModelConfig, params: LM, batch: Dict, *,
            cache: Optional[Dict[str, torch.Tensor]] = None,
            cache_pos: Optional[int] = None, flash: bool = True,
            remat: bool = False,
            param_hook: Callable[[Block], Block] = lambda lp: lp,
            decode_attn=None, cache_offset: Optional[int] = None,
            cache_group=None, tp=None
            ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Run the decoder stack: returns (hidden (B, S, D) after the final
    norm, the cache written in place or None).  ``flash=False``, or
    explicit ``batch['positions']`` (whose causal mask is theirs, not
    the token order), runs a prefill's attention through
    ``masked_attention`` instead of the flash kernel.

    ``param_hook`` is called on each layer's module before the layer
    runs -- the attach point of the early-bird gradient sync
    (``core.earlybird``).  ``remat`` recomputes each layer in backward
    (``torch.utils.checkpoint``) instead of keeping its activations; the
    hook is called outside the checkpointed region, so a recomputation
    does not call it again.  ``decode_attn`` is the attention layers'
    decode hook, ``cache_offset`` the first position a sequence-split
    cache holds and ``cache_group`` the group over its split
    (``attention.attention_fwd``).

    ``tp`` (``models.tp.TP``): ``params`` holds this rank's blocks
    (:func:`local_model`) and the layers run tensor-, expert- and, with
    ``tp.seq_parallel`` where ``tp.splits_seq`` the stream, sequence
    parallel; the hidden returned is then this rank's (B, S/M, D) block
    of the sequence (:func:`_last_hidden` takes the last position)."""
    x = _model_input(cfg, batch)
    seq_split = tp is not None and tp.splits_seq(x.shape[1])
    h = _embed_inputs(cfg, params, batch, tp, seq_split)
    b, s = h.shape[0], x.shape[1]
    positions = _positions(cfg, batch, b, s, cache_pos, h.device)
    flash = flash and "positions" not in batch
    for i, (lp, window) in enumerate(zip(params.layers, cfg.windows())):
        lp = param_hook(lp)
        layer_cache = None if cache is None else \
            {k: t[i] for k, t in cache.items()}
        kw = dict(positions=positions, window=window, cache=layer_cache,
                  cache_pos=cache_pos, flash=flash, decode_attn=decode_attn,
                  cache_offset=cache_offset)
        if tp is not None or cache_group is not None:
            kw.update(cache_group=cache_group, tp=tp, seq_split=seq_split)
        if remat and cache is None:
            h, _ = torch.utils.checkpoint.checkpoint(
                block_fwd, cfg, lp, h, use_reentrant=False, **kw)
        else:
            h, _ = block_fwd(cfg, lp, h, **kw)
    h = rms_norm(h, params.final_norm, zero_centered=cfg.zero_centered_norm)
    return h, cache


def _last_hidden(h: torch.Tensor, tp, s: int) -> torch.Tensor:
    """The last position's hidden (B, D) of :func:`forward`'s output for
    a stream of ``s`` positions: under sequence parallelism the last
    rank holds it, and the ranks' last positions are all-gathered."""
    if tp is not None and tp.splits_seq(s):
        return tpc.gather_seq(h[:, -1:], tp)[:, -1]
    return h[:, -1]


def output_head(cfg: ModelConfig, params: LM) -> torch.Tensor:
    return params.embed.T if cfg.tie_embeddings else params.head


def _final_logits(cfg: ModelConfig, h_last: torch.Tensor,
                  params: LM, tp=None) -> torch.Tensor:
    """Last-position logits in f32: the head's product in the parameter
    dtype, then the softcap, then the TP-padding mask.  Under ``tp`` the
    head (or the tied ``embed.T``) is this rank's vocabulary block: its
    logits are masked where the padding falls in it, then all-gathered
    to the whole (B, V) on every rank."""
    head = output_head(cfg, params)
    logits = tpc.enter(h_last, tp) @ head
    logits = softcap(logits.float(), cfg.final_softcap)
    lo = 0 if tp is None else tp.rank * head.shape[1]
    if cfg.vocab_padded > cfg.vocab and cfg.vocab - lo < head.shape[1]:
        logits[:, max(0, cfg.vocab - lo):] = -torch.inf
    return logits if tp is None else tpc.gather_vocab(logits, tp)


def loss_fn(cfg: ModelConfig, params: LM, batch: Dict, *,
            remat: bool = True,
            param_hook: Callable[[Block], Block] = lambda lp: lp,
            gather_targets: bool = False, tp=None) -> torch.Tensor:
    """Next-token cross entropy (labels = ``batch['labels']``), f32.

    ``tp``: the tensor-parallel training forward (:func:`forward`) and a
    vocab-parallel loss over this rank's block of the head (or of the
    tied ``embed.T``): the final hidden is gathered along the sequence
    when the stream is split (``tpc.gather_seq``, whose backward
    reduce-scatters the vocabulary blocks' partial input gradients),
    else entered (``tpc.enter``, an all-reduce backward), and
    ``chunked_cross_entropy`` runs on the block.  Every rank returns the
    same loss; the gradients of :func:`partial_grad_leaves` are partial
    sums over ``model`` that the caller adds."""
    h, _ = forward(cfg, params, batch, remat=remat, param_hook=param_hook,
                   tp=tp)
    if tp is not None:
        s = _model_input(cfg, batch).shape[1]
        h = tpc.gather_seq(h, tp) if tp.splits_seq(s) else tpc.enter(h, tp)
    return chunked_cross_entropy(
        h, output_head(cfg, params), batch["labels"],
        chunk=cfg.loss_chunk, final_softcap=cfg.final_softcap,
        mask=batch.get("loss_mask"),
        valid_vocab=(cfg.vocab if cfg.vocab_padded > cfg.vocab else None),
        gather_targets=gather_targets, tp=tp)


@torch.no_grad()
def prefill(cfg: ModelConfig, params: LM, batch: Dict, *,
            cache: Optional[Dict[str, torch.Tensor]] = None,
            flash: bool = True, cache_offset: Optional[int] = None,
            cache_group=None, tp=None) -> Tuple[torch.Tensor, Dict]:
    """Forward pass that fills a KV cache from position 0; returns
    (last-token logits (B, V) f32, the cache).  ``batch`` holds
    ``tokens`` (B, S), or ``embeds`` (B, S, d) for the audio stub, and
    optionally ``patch_embeds`` and ``positions``.  ``cache_offset`` and
    ``cache_group``: the cache holds only its sequence slice from there;
    ``tp``: the tensor-parallel forward (:func:`forward`)."""
    x = _model_input(cfg, batch)
    b, s = x.shape[:2]
    if cache is None:
        cache = init_cache(cfg, b, s, device=x.device)
    h, cache = forward(cfg, params, batch, cache=cache, cache_pos=0,
                       flash=flash, cache_offset=cache_offset,
                       cache_group=cache_group, tp=tp)
    return _final_logits(cfg, _last_hidden(h, tp, s), params, tp), cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: LM, cache: Dict[str, torch.Tensor],
                tokens: Optional[torch.Tensor], pos: int, *,
                embeds: Optional[torch.Tensor] = None, decode_attn=None,
                cache_offset: Optional[int] = None, cache_group=None,
                tp=None) -> Tuple[torch.Tensor, Dict]:
    """One decode step: tokens (B,) int, ``pos`` the write offset; the
    audio stub takes ``embeds`` (B, 1, d) instead.  ``decode_attn``: the
    attention layers' decode hook, ``cache_offset`` the first position a
    sequence-split cache holds and ``cache_group`` the group over its
    split (``attention.attention_fwd``); ``tp``: the tensor-parallel
    forward (:func:`forward`; one position never splits).  Returns
    (logits (B, V) f32, the cache written in place)."""
    batch = _decode_batch(cfg, tokens, embeds)
    h, cache = forward(cfg, params, batch, cache=cache, cache_pos=int(pos),
                       decode_attn=decode_attn, cache_offset=cache_offset,
                       cache_group=cache_group, tp=tp)
    return _final_logits(cfg, h[:, -1, :], params, tp), cache
