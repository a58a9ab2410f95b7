"""Model families as modules of their own (``families/<family>.py``).

- The two families the cells run give what the harness gave before they
  were moved, bit for bit (``families_parent.json``, recorded then).
- A family made of files alone, defined here in a temporary package on
  ``perfbench.families.__path__`` and ``perfbench.reference.__path__``,
  with a dense layer 0 and MoE layers 1..3: its leaves cover some of
  the layers, the yardstick sums them, and the plain reference runs.
- Families and references import nothing of the port.
- The port's copy of a leaf follows its ``layers``.
"""

import dataclasses
import hashlib
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import perfbench.families
import perfbench.reference
from perfbench import harness, port, weights
from perfbench import yardstick as y
from perfbench.families import family
from perfbench.reference import model as ref_model
from perfbench.sizes import load_config, sizes
from perfbench.tests import smoke
from perfbench.traffic.gen import load_mix

RECORD = json.loads((Path(__file__).parent / "families_parent.json")
                    .read_text())["configs"]
CONFIGS = sorted(RECORD)
SHAPES = [(4, 1024), (1, 8192), (8, 1024), (8, 2048), (8, 4096),
          (8, 8192), (3, 612)]
SEED = 2 ** 31 + 4243
# the tiny copies the draws and logits were recorded on: 2 layers, narrow
TINY = {
    "granite-moe-3b-a800m": dict(
        num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=32, num_local_experts=8,
        num_experts_per_tok=2, vocab_size=128),
    "mamba2-780m": dict(d_model=64, n_layer=2, vocab_size=120),
}


def _tiny(name: str):
    c = load_config(name)
    c.update(TINY[name])
    if c["family"] == "mamba2":
        c["mamba2_layer_defaults"] = dict(c["mamba2_layer_defaults"],
                                          d_state=16, headdim=16,
                                          chunk_size=16)
    return sizes(c)


def _digest(t: torch.Tensor) -> str:
    raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:16]


@pytest.fixture
def one_thread():
    """CPU sums in one order whatever the worker's thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The moved families, against what the harness gave before
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_sizes_as_recorded(name):
    s = sizes(load_config(name))
    assert dataclasses.asdict(s) == RECORD[name]["sizes"]


@pytest.mark.parametrize("name", CONFIGS)
def test_leaves_as_recorded(name):
    got = [[lf.name, list(lf.shape), lf.init, lf.fan_in, lf.f32, lf.layers]
           for lf in weights.leaves(sizes(load_config(name)))]
    assert got == RECORD[name]["leaves"]


@pytest.mark.parametrize("name", CONFIGS)
def test_yardstick_as_recorded(name):
    s = sizes(load_config(name))
    rec = RECORD[name]
    for b, n in SHAPES:
        assert [y.train_flops(s, b, n), y.prefill_flops(s, b, n),
                y.mixer_flops(s, b, n)] == rec["flops"][f"{b}x{n}"]
    assert y.proj_params(s) == rec["proj_params"]
    assert list(y.step_sync(s, 1 << 20)) == rec["step_sync"]


@pytest.mark.parametrize("name", CONFIGS)
def test_port_config_as_recorded(name):
    s = sizes(load_config(name))
    assert repr(port.model_config(s, "bfloat16")) == \
        RECORD[name]["port_config"]


@pytest.mark.parametrize("name", CONFIGS)
def test_draws_as_recorded(name, one_thread):
    s = _tiny(name)
    for dt, want in RECORD[name]["tiny_draws"].items():
        got = {lf.name: _digest(weights.draw(lf, SEED, "cpu",
                                             getattr(torch, dt)))
               for lf in weights.leaves(s)}
        assert got == want, dt


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_logits_as_recorded(name, one_thread):
    s = _tiny(name)
    W = weights.all_leaves(s, SEED, torch.device("cpu"), torch.float32)
    tok = torch.randint(1, s.token_ids, (2, 40),
                        generator=torch.Generator().manual_seed(5))
    got = ref_model.last_logits(s, W, tok)
    assert [_digest(got), float(got.double().sum())] == \
        RECORD[name]["tiny_logits"]


@pytest.mark.parametrize("name,train,prefill", [
    ("granite-moe-3b-a800m", ["bucket_pack"], ["flash_attention"]),
    ("mamba2-780m", ["bucket_pack"], [])])
def test_kernels_built_ahead(name, train, prefill):
    s = sizes(load_config(name))
    fam = family(s.family)
    assert fam.kernels_ahead(s, "train") == train
    assert fam.kernels_ahead(s, "prefill") == prefill


def test_unknown_family_is_named():
    with pytest.raises(ValueError, match="no_such_family"):
        sizes({"family": "no_such_family", "name": "x"})


# ---------------------------------------------------------------------------
# A family made of files alone: a dense layer 0, MoE layers 1..3
# ---------------------------------------------------------------------------

FAMILY = '''
"""Dense SwiGLU in the first ``n_dense`` layers, routed experts after."""
from dataclasses import asdict, dataclass

from perfbench.families import granite_moe
from perfbench.sizes import Sizes
from perfbench.weights import Leaf, outer_leaves
from perfbench.yardstick import causal_pairs


@dataclass(frozen=True)
class DenseMoESizes(Sizes):
    d_ff: int = 0
    n_dense: int = 0


def sizes(conf):
    base = granite_moe.sizes(conf)
    return DenseMoESizes(**{**asdict(base), "d_ff": conf["d_ff"],
                            "n_dense": conf["n_dense"]})


def leaves(s):
    L, d, f = s.n_layers, s.d_model, s.d_ff
    dense = tuple(range(s.n_dense))
    moe = tuple(range(s.n_dense, L))
    h, kv, hd, e, fe = s.n_heads, s.n_kv, s.head_dim, s.n_experts, \\
        s.d_expert
    return outer_leaves(s) + [
        Leaf("layers.ln1", (L, d), "ones"),
        Leaf("layers.attn.wq", (L, d, h, hd), "normal", d),
        Leaf("layers.attn.wk", (L, d, kv, hd), "normal", d),
        Leaf("layers.attn.wv", (L, d, kv, hd), "normal", d),
        Leaf("layers.attn.wo", (L, h, hd, d), "normal", h * hd),
        Leaf("layers.ln2", (L, d), "ones"),
        Leaf("layers.mlp.w_gate", (len(dense), d, f), "normal", d,
             layers=dense),
        Leaf("layers.mlp.w_up", (len(dense), d, f), "normal", d,
             layers=dense),
        Leaf("layers.mlp.w_down", (len(dense), f, d), "normal", f,
             layers=dense),
        Leaf("layers.moe.router", (len(moe), d, e), "normal", d, True,
             layers=moe),
        Leaf("layers.moe.w_gate", (len(moe), e, d, fe), "normal", d,
             layers=moe),
        Leaf("layers.moe.w_up", (len(moe), e, d, fe), "normal", d,
             layers=moe),
        Leaf("layers.moe.w_down", (len(moe), e, fe, d), "normal", fe,
             layers=moe)]


def proj_params(s, i):
    d = s.d_model
    attn = 2 * d * s.n_heads * s.head_dim + 2 * d * s.n_kv * s.head_dim
    if i < s.n_dense:
        return attn + 3 * d * s.d_ff
    return attn + d * s.n_experts + s.top_k * 3 * d * s.d_expert


def mixer_flops(s, i, batch, n):
    return 4 * batch * s.n_heads * s.head_dim * causal_pairs(n)


def kernels_ahead(s, kind):
    return {"train": ["bucket_pack"], "prefill": ["flash_attention"]}[kind]
'''

REFERENCE = '''
"""Plain reference of the dense-then-MoE family."""
from perfbench.reference.common import at, linear, rms_norm, silu
from perfbench.reference.granite_moe import attention, head, moe


def mlp(s, W, i, x, precision):
    w = lambda k: at(s, W, f"layers.mlp.{k}", i)   # noqa: E731
    g = silu(linear(x, w("w_gate"), precision)) \\
        * linear(x, w("w_up"), precision)
    return linear(g, w("w_down"), precision)


def layer(s, W, i, h, precision):
    h = h + attention(s, W, i, rms_norm(h, at(s, W, "layers.ln1", i),
                                        s.eps), precision)
    ffn = mlp if i < s.n_dense else moe
    return h + ffn(s, W, i, rms_norm(h, at(s, W, "layers.ln2", i), s.eps),
                   precision)
'''

NAME = "dense_moe_only_in_a_test"


@pytest.fixture
def dense_moe(tmp_path):
    """The family's two files in temporary packages, found by name; the
    sizes of a 4-layer model of it."""
    added = []
    for pkg, src in ((perfbench.families, FAMILY),
                     (perfbench.reference, REFERENCE)):
        d = tmp_path / pkg.__name__.split(".")[-1]
        d.mkdir()
        (d / f"{NAME}.py").write_text(textwrap.dedent(src))
        pkg.__path__.append(str(d))
        added.append((pkg, str(d)))
    conf = dict(smoke.granite(), family=NAME, name="dense-moe-t",
                num_hidden_layers=4, d_ff=48, n_dense=1,
                tie_word_embeddings=False)
    try:
        yield sizes(conf)
    finally:
        for pkg, d in added:
            pkg.__path__.remove(d)
            sys.modules.pop(f"{pkg.__name__}.{NAME}", None)


def test_a_file_only_family_loads(dense_moe):
    s = dense_moe
    assert type(s).__name__ == "DenseMoESizes"
    assert (s.family, s.n_layers, s.d_ff, s.n_dense) == (NAME, 4, 48, 1)
    by = {lf.name: lf for lf in weights.leaves(s)}
    assert by["layers.mlp.w_up"].shape == (1, s.d_model, 48)
    assert by["layers.moe.w_up"].shape[0] == 3
    slots = weights.layer_slots(s)
    assert slots["layers.mlp.w_gate"] == {0: 0}
    assert slots["layers.moe.router"] == {1: 0, 2: 1, 3: 2}
    assert slots["layers.ln1"] == {i: i for i in range(4)}
    assert "head" in by                           # untied


def test_the_yardstick_sums_its_layers(dense_moe):
    s = dense_moe
    d, hd = s.d_model, s.head_dim
    attn = 2 * d * s.n_heads * hd + 2 * d * s.n_kv * hd
    dense = attn + 3 * d * 48
    sparse = attn + d * s.n_experts + s.top_k * 3 * d * s.d_expert
    mix = 4 * 2 * s.n_heads * hd * (16 * 17 // 2)
    layers = 2 * (dense + 3 * sparse) * 2 * 16 + 4 * mix
    assert y.prefill_flops(s, 2, 16) == layers + 2 * d * s.vocab * 2
    assert y.train_flops(s, 2, 16) == 3 * (layers + 2 * d * s.vocab * 32)
    assert y.mixer_flops(s, 2, 16) == mix      # attention alike in all
    with pytest.raises(ValueError, match="differ"):
        y.proj_params(s)
    # layer 0's gradients are other leaves than layers 1..3's
    assert [n for n, _ in y.leaf_bytes(s, 0)] == [
        "layers.attn.wk", "layers.attn.wo", "layers.attn.wq",
        "layers.attn.wv", "layers.ln1", "layers.ln2", "layers.mlp.w_down",
        "layers.mlp.w_gate", "layers.mlp.w_up"]
    assert "layers.moe.router" in dict(y.leaf_bytes(s, 3))
    allreduces, _, _ = y.step_sync(s, 1 << 20)
    per_layer = [len(y.buckets([n for _, n in y.leaf_bytes(s, i)], 1 << 20))
                 for i in range(4)]
    outer = len(y.buckets([n for _, n in y.leaf_bytes(s, None)], 1 << 20))
    assert allreduces == sum(per_layer) + outer + 1


def test_the_reference_runs_a_file_only_family(dense_moe):
    s = dense_moe
    W = weights.all_leaves(s, SEED, torch.device("cpu"), torch.float32)
    tok = torch.randint(1, s.token_ids, (2, 24),
                        generator=torch.Generator().manual_seed(3))
    logits = ref_model.last_logits(s, W, tok)
    assert logits.shape == (2, s.vocab) and bool(logits.isfinite().all())
    # layer 0 runs the dense MLP and layers 1..3 the experts
    for leaf in ("layers.mlp.w_down", "layers.moe.w_down"):
        cut = dict(W, **{leaf: torch.zeros_like(W[leaf])})
        assert not torch.equal(ref_model.last_logits(s, cut, tok), logits)
    # a training step's slices are named by global layer index
    mix = load_mix("train_4x1024")
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    out = ref_model.train(s, {k: t.clone() for k, t in W.items()}, [batch],
                          dict(mix, remat=False),
                          lambda k: W[k])
    names = set(out["grad1_s"])
    assert {"layers.0.mlp.w_up", "layers.1.moe.router",
            "layers.3.moe.w_up.0"} <= names
    assert "layers.0.moe.router" not in names
    assert "layers.1.mlp.w_up" not in names
    assert set(out["change"]) == set(W)


# ---------------------------------------------------------------------------
# Import boundaries
# ---------------------------------------------------------------------------

def test_families_and_references_import_nothing_of_the_port():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.path[:0] = ['.', 'src']
        import perfbench.families, perfbench.reference
        for pkg in (perfbench.families, perfbench.reference):
            for m in pkgutil.iter_modules(pkg.__path__):
                importlib.import_module(pkg.__name__ + '.' + m.name)
        print(sorted(m for m in sys.modules
                     if m.split('.')[0] in ('repro_torch', 'repro', 'jax')))
        """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.CHECKOUT, check=True)
    assert out.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# The port's copy of a leaf follows its layers
# ---------------------------------------------------------------------------

def _granite_model(without_router_in=()):
    """A granite smoke model on the CPU, without the router in the
    layers named."""
    from repro_torch.models.lm import LM
    s = sizes(smoke.granite())
    model = LM(port.model_config(s, "float32"), device="cpu")
    for i in without_router_in:
        model.layers[i].moe.router = None
    return s, model


def _specs(s, router_layers):
    """The granite leaves with the router over ``router_layers``."""
    out = []
    for lf in weights.leaves(s):
        if lf.name == "layers.moe.router" and router_layers is not None:
            lf = dataclasses.replace(
                lf, shape=(len(router_layers), *lf.shape[1:]),
                layers=router_layers)
        out.append(lf)
    return out


@pytest.mark.parametrize("port_lacks,leaf_layers", [
    ((), (1,)), ((0,), (0,)), ((0,), None)],
    ids=["fewer", "another_layer", "more"])
def test_build_refuses_leaf_layers_the_port_lacks(port_lacks, leaf_layers):
    s, model = _granite_model(port_lacks)
    with pytest.raises(ValueError, match="layers.moe.router"):
        port.load(model, s, _specs(s, leaf_layers), SEED,
                  torch.device("cpu"), torch.float32)


def test_a_leaf_over_layer_1_lands_in_layer_1():
    s, model = _granite_model(without_router_in=(0,))
    specs = _specs(s, (1,))
    port.load(model, s, specs, SEED, torch.device("cpu"), torch.float32)
    lf = next(x for x in specs if x.name == "layers.moe.router")
    want = weights.draw(lf, SEED, torch.device("cpu"), torch.float32)
    assert want.shape[0] == 1
    assert torch.equal(model.layers[1].moe.router, want[0])
    assert model.layers[0].moe.router is None
    # every other leaf as the whole-model build places it
    _, full = port.build_model(s, SEED, torch.device("cpu"), torch.float32)
    ref = dict(full.named_parameters())
    for name, p in model.named_parameters():
        if name != "layers.1.moe.router":
            assert torch.equal(p, ref[name]), name
