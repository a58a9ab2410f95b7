"""The port's qwen2-vl-7b (M-RoPE, vision stub) and musicgen-medium (audio
stub) against the JAX package.

For both smoke configs the JAX package's ``init_params(PRNGKey(0))`` is
carried across with ``convert.params_from_jax``; the port's ``forward``,
``prefill`` (logits and every cache entry), three ``decode_step``s, a
decode from a cache JAX filled and ``loss_fn`` must equal
``repro.models.lm`` in f32 within 1e-4.  qwen2-vl runs with JAX's
default positions and with explicit (3, B, S) positions whose rows
differ (a t/h/w grid over the patches, then text positions), so that
every M-RoPE section is driven by its own row; musicgen runs from frame
embeddings and decodes from them.  Also: ``apply_rope`` with M-RoPE
against JAX over random sections, distinct position rows and bf16
input, its assertions, too many patches raising in both packages, the
configs field for field, the leaves of the parameter tree, the serving
steps and CLI in bf16, and the per-architecture smoke checks of
``tests/test_arch_smoke.py`` on the port.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import configs as pconfigs
from repro_torch import serve
from repro_torch.launch import steps
from repro_torch.models import convert, layers as players, lm as plm

from _torch_models import grid_positions

ARCHS = ("qwen2-vl-7b", "musicgen-medium")
TOL = 1e-4
B, S, GEN = 2, 24, 3
N_PATCH = 8  # a 1 x 2 x 4 patch grid in the smoke runs


def _asdict(cfg):
    return {k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
            for k, v in ((f.name, getattr(cfg, f.name))
                         for f in dataclasses.fields(cfg))}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def make_inputs(cfg, b, s, seed=0, explicit=False):
    """A NumPy prefill batch: tokens, or frame embeddings for the audio
    stub; the vision stub's patch embeddings and, with ``explicit``, its
    grid positions."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_stub":
        out = {"embeds": rng.standard_normal((b, s, cfg.d_model),
                                             dtype=np.float32)}
    else:
        out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        out["patch_embeds"] = rng.standard_normal((b, N_PATCH, cfg.d_model),
                                                  dtype=np.float32)
        if explicit:
            out["positions"] = grid_positions(b, s, 1, 2, 4)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _p(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX config, JAX params, port config, port model) of one smoke
    architecture, the weights carried across from JAX."""
    jc = jconfigs.get_smoke_config(request.param)
    pc = pconfigs.get_smoke_config(request.param)
    params = jlm.init_params(jc, jax.random.PRNGKey(0))
    model = convert.params_from_jax(jax.tree.map(np.asarray, params), pc,
                                    device="cpu")
    return jc, params, pc, model


# the position variants of each architecture
CASES = [("qwen2-vl-7b", False), ("qwen2-vl-7b", True),
         ("musicgen-medium", False)]


@pytest.fixture(params=CASES, ids=["qwen2-vl-default", "qwen2-vl-explicit",
                                   "musicgen-embeds"])
def case(request):
    arch, explicit = request.param
    jc = jconfigs.get_smoke_config(arch)
    pc = pconfigs.get_smoke_config(arch)
    params = _PARAMS.setdefault(arch, jlm.init_params(
        jc, jax.random.PRNGKey(0)))
    model = convert.params_from_jax(jax.tree.map(np.asarray, params), pc,
                                    device="cpu")
    return jc, params, pc, model, explicit


_PARAMS = {}


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

def _sections(rng, half):
    cut = np.sort(rng.choice(np.arange(1, half), size=2, replace=False))
    return (int(cut[0]), int(cut[1] - cut[0]), int(half - cut[1]))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mrope_matches_jax(seed, dtype):
    """Random sections, distinct position rows (3, B, S) and (3, S)."""
    rng = np.random.default_rng(seed)
    d = int(rng.choice([8, 16, 32]))
    secs = _sections(rng, d // 2)
    x = rng.standard_normal((2, 7, 3, d)).astype(np.float32)
    for pos in (rng.integers(0, 50, (3, 2, 7)), rng.integers(0, 50, (3, 7))):
        pos = pos.astype(np.int32)
        assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
        want = jlayers.apply_rope(jnp.asarray(x, dtype), jnp.asarray(pos),
                                  1e6, secs)
        got = players.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                                 torch.from_numpy(pos), 1e6, secs)
        assert str(got.dtype) == "torch." + dtype
        tol = 1e-6 if dtype == "float32" else 2 ** -8
        _close(got, np.asarray(want.astype(jnp.float32)), tol)
        # the sections are driven by their own rows: a different row
        # changes the result
        other = pos.copy()
        other[2] += 1
        moved = players.apply_rope(torch.from_numpy(x),
                                   torch.from_numpy(other), 1e6, secs)
        assert not torch.allclose(moved, players.apply_rope(
            torch.from_numpy(x), torch.from_numpy(pos), 1e6, secs))


def test_mrope_equal_rows_equal_classic_rope():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 5, 2, 16)).astype(np.float32))
    pos = torch.arange(5)
    got = players.apply_rope(x, pos.expand(3, 5), 1e4, (2, 3, 3))
    torch.testing.assert_close(got, players.apply_rope(x, pos, 1e4),
                               rtol=0, atol=0)


def test_mrope_assertions_follow_jax():
    x = torch.zeros((1, 4, 1, 16))
    with pytest.raises(AssertionError, match=r"\(3, \.\.\., S\)"):
        players.apply_rope(x, torch.zeros((2, 1, 4)), 1e4, (2, 3, 3))
    with pytest.raises(AssertionError):
        players.apply_rope(x, torch.zeros((3, 1, 4)), 1e4, (2, 3, 4))
    with pytest.raises(AssertionError):
        jlayers.apply_rope(jnp.zeros((1, 4, 1, 16)), jnp.zeros((3, 1, 4)),
                           1e4, (2, 3, 4))


# ---------------------------------------------------------------------------
# Per architecture
# ---------------------------------------------------------------------------

def test_forward_matches_jax(case):
    jc, params, pc, model, explicit = case
    batch = make_inputs(jc, B, S, explicit=explicit)
    want, _ = jlm.forward(jc, params, _j(batch))
    got, cache = plm.forward(pc, model, _p(batch))
    assert cache is None
    _close(got, want)


def _decode_input(cfg, rng, tok):
    if cfg.frontend == "audio_stub":
        e = rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
        return dict(embeds=e), dict(embeds=torch.from_numpy(e))
    return {}, {}


def test_prefill_and_three_decodes_match_jax(case):
    """Prefill into a cache longer than the prompt, then three greedy
    decode steps (musicgen: three seeded frames); logits and every
    cache entry after each."""
    jc, params, pc, model, explicit = case
    batch = make_inputs(jc, B, S, explicit=explicit)
    jl, jcache = jlm.prefill(jc, params, _j(batch),
                             cache=jlm.init_cache(jc, B, S + GEN))
    pl, pcache = plm.prefill(pc, model, _p(batch),
                             cache=plm.init_cache(pc, B, S + GEN,
                                                  device="cpu"))
    assert set(pcache) == set(jcache) == {"k", "v"}
    _close(pl, jl)
    for name in jcache:
        _close(pcache[name], jcache[name])
    rng = np.random.default_rng(5)
    for t in range(GEN):
        tok = np.argmax(np.asarray(jl)[:, :jc.vocab], -1).astype(np.int32)
        je, pe = _decode_input(jc, rng, tok)
        jl, jcache = jlm.decode_step(
            jc, params, jcache, jnp.asarray(tok), jnp.int32(S + t),
            embeds=None if not je else jnp.asarray(je["embeds"]))
        pl, pcache = plm.decode_step(pc, model, pcache,
                                     torch.from_numpy(tok), S + t, **pe)
        _close(pl, jl)
        for name in jcache:
            _close(pcache[name], jcache[name])


def test_decode_from_jax_cache(pair):
    """A cache the JAX package filled, carried across, decodes as JAX."""
    jc, params, pc, model = pair
    batch = make_inputs(jc, B, S, seed=2)
    _, jcache = jlm.prefill(jc, params, _j(batch),
                            cache=jlm.init_cache(jc, B, S + 1))
    pcache = convert.cache_from_jax(jax.tree.map(np.asarray, jcache),
                                    device="cpu")
    tok = np.ones(B, np.int32)
    je, pe = _decode_input(jc, np.random.default_rng(6), tok)
    jl, jcache = jlm.decode_step(
        jc, params, jcache, jnp.asarray(tok), jnp.int32(S),
        embeds=None if not je else jnp.asarray(je["embeds"]))
    pl, pcache = plm.decode_step(pc, model, pcache, torch.from_numpy(tok), S,
                                 **pe)
    _close(pl, jl)
    back = convert.cache_to_numpy(pcache)
    for name in jcache:
        _close(torch.from_numpy(back[name]), jcache[name])


def test_loss_matches_jax(case):
    jc, params, pc, model, explicit = case
    batch = make_inputs(jc, B, S, explicit=explicit)
    batch["labels"] = np.random.default_rng(1).integers(
        0, jc.vocab, (B, S)).astype(np.int32)
    want = jlm.loss_fn(jc, params, _j(batch))
    got = plm.loss_fn(pc, model, _p(batch))
    _close(got, want)


def test_explicit_positions_reach_the_sections(pair):
    """qwen2-vl: grid positions give other hidden states than the default
    ones (the sections see distinct rows); musicgen reads no tokens."""
    jc, params, pc, model = pair
    if jc.frontend == "audio_stub":
        batch = make_inputs(jc, B, S)
        got, _ = plm.forward(pc, model, {**_p(batch),
                                         "tokens": torch.zeros((B, S))})
        want, _ = plm.forward(pc, model, _p(batch))
        assert torch.equal(got, want)
        with pytest.raises(KeyError, match="embeds"):
            plm.forward(pc, model, {"tokens": torch.zeros((B, S),
                                                          dtype=torch.long)})
        return
    a, _ = plm.forward(pc, model, _p(make_inputs(jc, B, S)))
    b, _ = plm.forward(pc, model, _p(make_inputs(jc, B, S, explicit=True)))
    assert float((a - b).abs().max()) > 1e-3


def test_patches_overwrite_the_first_embeddings():
    cfg = pconfigs.get_smoke_config("qwen2-vl-7b")
    model = serve.build_model(cfg, 0, "cpu")
    batch = _p(make_inputs(cfg, B, S))
    h = plm._embed_inputs(cfg, model, batch)
    assert torch.equal(h[:, :N_PATCH], batch["patch_embeds"])
    assert torch.equal(h[:, N_PATCH:],
                       model.embed[batch["tokens"][:, N_PATCH:].long()])
    without = {k: v for k, v in batch.items() if k != "patch_embeds"}
    assert torch.equal(plm._embed_inputs(cfg, model, without)[:, N_PATCH:],
                       h[:, N_PATCH:])


def test_too_many_patches_raise_in_both_packages():
    jc = jconfigs.get_smoke_config("qwen2-vl-7b")
    pc = pconfigs.get_smoke_config("qwen2-vl-7b")
    params = jlm.init_params(jc, jax.random.PRNGKey(0))
    model = convert.params_from_jax(jax.tree.map(np.asarray, params), pc,
                                    device="cpu")
    batch = make_inputs(jc, B, 6)  # 8 patches, 6 tokens
    with pytest.raises(Exception):
        jlm.forward(jc, params, _j(batch))
    with pytest.raises(ValueError, match="do not fit"):
        plm.forward(pc, model, _p(batch))
    prefill = steps.make_prefill_step(pc, steps.StepConfig(), seq_len=6,
                                      batch=B, device="cpu")
    cache = steps.make_cache(pc, steps.StepConfig(), batch=B, max_len=6,
                             device="cpu")
    with pytest.raises(ValueError, match="patch_embeds"):
        prefill(plm.cast(model, torch.bfloat16), _p(batch), cache)


def test_prefill_matches_incremental_decode(pair):
    """``serve.check_consistency``: musicgen frame by frame, qwen2-vl on
    text (JAX's decode takes no patches)."""
    _, _, pc, model = pair
    prompt = serve.make_prompts(pc, 2, 24, 1, "cpu")
    assert prompt.dim() == (3 if pc.frontend == "audio_stub" else 2)
    assert serve.check_consistency(pc, model, prompt) < serve.CONSISTENCY_TOL


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_match_jax(arch):
    for get in ("get_config", "get_smoke_config"):
        jc = getattr(jconfigs, get)(arch)
        pc = getattr(pconfigs, get)(arch)
        assert _asdict(pc) == _asdict(jc)
        assert pc.param_count() == jc.param_count()
        assert pc.param_count(padded=True) == jc.param_count(padded=True)
        assert pc.windows() == jc.windows()
        assert pc.head_map == jc.head_map


@pytest.mark.parametrize("arch", ARCHS)
def test_leaves_match_jax_tree(arch):
    """Names, shapes and dtypes of every leaf equal the JAX tree's in
    bf16, at full width and two layers (``meta`` device)."""
    jc = jconfigs.get_config(arch).replace(n_layers=2)
    pc = pconfigs.get_config(arch).replace(n_layers=2)
    shapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                          jlm.param_shapes(jc.replace(param_dtype="bfloat16")))
    model = plm.LM(pc, device="meta", dtype=torch.bfloat16)
    got = {name: ((pc.n_layers, *segs[0].shape) if name.startswith("layers.")
                  else tuple(segs[0].shape), str(segs[0].dtype))
           for name, segs in plm.param_leaves(model.named_parameters())}
    want = {".".join(str(k.key) for k in path): (tuple(s), "torch." + d)
            for path, (s, d) in jax.tree_util.tree_leaves_with_path(
                shapes, is_leaf=lambda x: isinstance(x, tuple)
                and len(x) == 2 and isinstance(x[1], str))}
    assert got == want


def test_arch_ids_equal_the_reference():
    assert set(pconfigs.ARCH_IDS) == set(jconfigs.ARCH_IDS)
    assert len(pconfigs.ARCH_IDS) == 10


# ---------------------------------------------------------------------------
# Serving entry points in bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serving_steps_in_bf16(arch):
    cfg = pconfigs.get_smoke_config(arch)
    scfg = steps.StepConfig()
    model = plm.cast(serve.build_model(cfg, 0, "cpu"), torch.bfloat16)
    s, gen = 64, 4
    prompts, extra = serve.serving_inputs(cfg, 2, s, gen, 0, "cpu")
    out = serve.generate(cfg, scfg, model, prompts, gen, **extra)
    logits = out["prefill_logits"]
    assert logits.shape == (2, cfg.vocab_padded)
    assert logits.dtype == torch.float32
    assert bool(torch.isfinite(logits[:, :cfg.vocab]).all())
    assert tuple(out["tokens"].shape) == (2, gen)
    if arch == "qwen2-vl-7b":
        assert tuple(extra["patch_embeds"].shape) == (2, serve.N_PATCHES,
                                                      cfg.d_model)
    else:
        assert prompts.shape == (2, s, cfg.d_model)
        assert tuple(extra["frames"].shape) == (2, gen, cfg.d_model)
        # the frames continue the prompt's seeded stream
        whole = serve.make_prompts(cfg, 2, s + gen, 0, "cpu")
        assert torch.equal(whole[:, s:], extra["frames"])
    decode = steps.make_decode_step(cfg, scfg, seq_len=s + 1, batch=2,
                                    device="cpu")
    cache = steps.make_cache(cfg, scfg, batch=2, max_len=s + 1, device="cpu")
    if arch == "musicgen-medium":
        with pytest.raises(ValueError, match="embeds missing"):
            decode(model, cache, out["tokens"][:, 0], s)
        decode(model, cache, None, s, embeds=extra["frames"][:, :1])
    else:
        with pytest.raises(ValueError, match="tokens"):
            decode(model, cache, out["tokens"][:1, 0], s)
    prefill = steps.make_prefill_step(cfg, scfg, seq_len=s, batch=2,
                                      device="cpu")
    bad = {"embeds" if arch == "musicgen-medium" else "tokens": prompts[:1]}
    with pytest.raises(ValueError, match="need"):
        prefill(model, bad, cache)


@pytest.mark.parametrize("arch", ["llama3.2-1b", *ARCHS])
def test_model_input_is_named_once(arch):
    """``lm.input_key`` names the model's input (the audio stub's frame
    embeddings, else tokens); ``input_batch`` puts it there with the
    extras that are given; a decode step without its input, or with
    embeds for a model that reads tokens, raises a ValueError naming
    it."""
    cfg = pconfigs.get_smoke_config(arch)
    key = "embeds" if cfg.frontend == "audio_stub" else "tokens"
    assert plm.input_key(cfg) == key
    x = torch.zeros((2, 4))
    pe = torch.zeros((2, 1, cfg.d_model))
    assert plm.input_batch(cfg, x, patch_embeds=None, positions=None) \
        == {key: x}
    got = plm.input_batch(cfg, x, patch_embeds=pe)
    assert set(got) == {key, "patch_embeds"} and got["patch_embeds"] is pe
    model = serve.build_model(cfg, 0, "cpu")
    cache = plm.init_cache(cfg, 2, 4, device="cpu")
    tok = torch.zeros(2, dtype=torch.long)
    with pytest.raises(ValueError, match=key):
        plm.decode_step(cfg, model, cache, None, 0)
    if key == "tokens":
        with pytest.raises(ValueError, match="embeds"):
            plm.decode_step(cfg, model, cache, tok, 0,
                            embeds=torch.zeros((2, 1, cfg.d_model)))
    else:  # the tokens are unread beside the frame, as in JAX
        a, _ = plm.decode_step(cfg, model, cache, tok, 0, embeds=pe)
        b, _ = plm.decode_step(cfg, model,
                               plm.init_cache(cfg, 2, 4, device="cpu"),
                               None, 0, embeds=pe)
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--prompt-len", "64", "--gen", "4",
                       "--batch", "2"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["arch"] == arch + "-smoke" and rec["device"] == "cpu"
    assert np.array(rec["tokens"]).shape == (2, 4)
    assert rec["prefill_decode_max_abs_err"] < serve.CONSISTENCY_TOL


def test_serve_cli_too_short_for_the_patches():
    with pytest.raises(ValueError, match=r"patch_embeds .*P <= 16"):
        serve.main(["--arch", "qwen2-vl-7b", "--smoke", "--device", "cpu",
                    "--prompt-len", "16", "--gen", "1", "--batch", "1"])


# ---------------------------------------------------------------------------
# tests/test_arch_smoke.py on the port
# ---------------------------------------------------------------------------

def _smoke_batch(cfg):
    """``test_arch_smoke.make_batch``'s shapes: B 2, S 32, 8 patches."""
    b, s = 2, 32
    batch = make_inputs(cfg, b, s, seed=1)
    batch["labels"] = np.random.default_rng(2).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)
    return _p(batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_shapes_and_finite(arch):
    cfg = pconfigs.get_smoke_config(arch)
    model = serve.build_model(cfg, 0, "cpu")
    h, c = plm.forward(cfg, model, _smoke_batch(cfg))
    assert tuple(h.shape) == (2, 32, cfg.d_model) and c is None
    assert bool(torch.isfinite(h).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_loss_and_grads_finite(arch):
    cfg = pconfigs.get_smoke_config(arch)
    model = serve.build_model(cfg, 0, "cpu").requires_grad_(True)
    loss = plm.loss_fn(cfg, model, _smoke_batch(cfg))
    loss.backward()
    assert 0.1 * np.log(cfg.vocab) < float(loss) < 3.0 * np.log(cfg.vocab)
    grads = {n: p.grad for n, p in model.named_parameters()}
    unread = set(plm.unread_params(cfg))
    assert unread == ({"embed"} if arch == "musicgen-medium" else set())
    assert all(grads[n] is None for n in unread)
    assert all(bool(torch.isfinite(g).all()) for n, g in grads.items()
               if n not in unread)
    assert any(float(g.abs().max()) > 0 for n, g in grads.items()
               if n not in unread)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_prefill_then_decode(arch):
    cfg = pconfigs.get_smoke_config(arch)
    model = serve.build_model(cfg, 0, "cpu")
    batch = {k: v for k, v in _smoke_batch(cfg).items() if k != "labels"}
    logits, _ = plm.prefill(cfg, model, batch)
    assert tuple(logits.shape) == (2, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    cache = plm.init_cache(cfg, 2, 36, device="cpu")
    tok = torch.zeros(2, dtype=torch.long)
    embeds = (torch.zeros((2, 1, cfg.d_model))
              if cfg.frontend == "audio_stub" else None)
    for pos in (0, 1):
        logits, cache = plm.decode_step(cfg, model, cache, tok, pos,
                                        embeds=embeds)
        assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_shapes_are_exact(arch):
    cfg = pconfigs.get_config(arch)
    table = {"musicgen-medium": (48, 1536, 24, 24, 6144, 2048),
             "qwen2-vl-7b": (28, 3584, 28, 4, 18944, 152064)}
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_ff,
            cfg.vocab) == table[arch]
    if arch == "qwen2-vl-7b":
        assert cfg.mrope_sections == (16, 24, 24)
        assert sum(cfg.mrope_sections) == cfg.head_dim_ // 2
        assert cfg.frontend == "vision_stub"
    else:
        assert cfg.frontend == "audio_stub" and not cfg.tie_embeddings
