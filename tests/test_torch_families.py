"""The port's MLA, Mamba-2, MoE and hybrid models against the JAX package.

For the smoke configs of minicpm3-4b (MLA), mamba2-780m (Mamba-2),
granite-moe-3b-a800m and moonshot-v1-16b-a3b (MoE) and hymba-1.5b (the
hybrid), the JAX package's ``init_params(PRNGKey(0))`` is carried across
with ``convert.params_from_jax``; the port's ``forward``, ``prefill``
(logits and every cache entry), three ``decode_step``s and ``loss_fn``
must equal ``repro.models.lm`` in f32 within 1e-4 (the reached errors are
about 3e-6).  Per module, with weights from the JAX initialisers: the
MoE FFN over one chunk, several chunks, a ragged token count, capacity
drops and padded experts (the chosen experts equal JAX's); the chunked
SSD scan over ragged lengths, an initial state and grouped B/C; the
Mamba-2 mixer over a full sequence, a prefill into a cache and three
decode tokens; MLA over a prefill and three decodes.  Also: prefill
against token-by-token decode, the configs field for field, the
initialisers, the serving steps and CLI in bf16, and one step of each
family's training CLI.  Their bf16 logits against JAX are in
``test_torch_families_bf16.py``, their training against JAX in
``test_torch_train_families.py``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro_torch import configs as pconfigs
from repro_torch import serve
from repro_torch.launch import steps
from repro_torch.launch import train as ptrain
from repro_torch.models import attention as pattn
from repro_torch.models import convert
from repro_torch.models import lm as plm
from repro_torch.models import mamba as pmamba
from repro_torch.models import moe as pmoe

ARCHS = ("minicpm3-4b", "mamba2-780m", "granite-moe-3b-a800m",
         "moonshot-v1-16b-a3b", "hymba-1.5b")
TOL = 1e-4
S, GEN = 24, 3
# A top-k boundary closer than this is a near-tie: f32 rounding of the
# router product may order it either way in the two packages.
TIE_GAP = 1e-5


def _asdict(cfg):
    return {k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
            for k, v in ((f.name, getattr(cfg, f.name))
                         for f in dataclasses.fields(cfg))}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _load(module, tree):
    """Copy a JAX parameter dict (one module's) into ``module``."""
    params = dict(module.named_parameters())
    assert set(params) == set(tree)
    with torch.no_grad():
        for name, p in params.items():
            a = np.asarray(tree[name])
            assert tuple(a.shape) == tuple(p.shape), name
            p.copy_(_t(a))
    return module


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


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


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


# ---------------------------------------------------------------------------
# Per architecture
# ---------------------------------------------------------------------------

def test_forward_matches_jax(pair):
    jc, params, pc, model = pair
    toks = _tokens(jc, 2, S)
    want, _ = jlm.forward(jc, params, {"tokens": jnp.asarray(toks)})
    got, cache = plm.forward(pc, model, {"tokens": torch.from_numpy(toks)})
    assert cache is None
    _close(got, want)


def test_prefill_and_three_decodes_match_jax(pair):
    """Prefill into a cache longer than the prompt, then three greedy
    decode steps; logits and every cache entry after each."""
    jc, params, pc, model = pair
    toks = _tokens(jc, 2, S)
    jl, jcache = jlm.prefill(jc, params, {"tokens": jnp.asarray(toks)},
                             cache=jlm.init_cache(jc, 2, S + GEN))
    pl, pcache = plm.prefill(pc, model, {"tokens": torch.from_numpy(toks)},
                             cache=plm.init_cache(pc, 2, S + GEN,
                                                  device="cpu"))
    assert set(pcache) == set(jcache)
    _close(pl, jl)
    for name in jcache:
        assert tuple(pcache[name].shape) == jcache[name].shape, name
        _close(pcache[name], jcache[name])
    for t in range(GEN):
        tok = np.argmax(np.asarray(jl)[:, :jc.vocab], -1).astype(np.int32)
        jl, jcache = jlm.decode_step(jc, params, jcache, jnp.asarray(tok),
                                     jnp.int32(S + t))
        pl, pcache = plm.decode_step(pc, model, pcache,
                                     torch.from_numpy(tok), S + t)
        _close(pl, jl)
        for name in jcache:
            _close(pcache[name], jcache[name])


def test_decode_from_jax_cache(pair):
    """A cache the JAX package filled, carried across, decodes as JAX."""
    jc, params, pc, model = pair
    toks = _tokens(jc, 2, S, seed=2)
    _, jcache = jlm.prefill(jc, params, {"tokens": jnp.asarray(toks)},
                            cache=jlm.init_cache(jc, 2, S + 1))
    pcache = convert.cache_from_jax(jax.tree.map(np.asarray, jcache),
                                    device="cpu")
    tok = np.ones(2, np.int32)
    jl, jcache = jlm.decode_step(jc, params, jcache, jnp.asarray(tok),
                                 jnp.int32(S))
    pl, pcache = plm.decode_step(pc, model, pcache, torch.from_numpy(tok), S)
    _close(pl, jl)
    back = convert.cache_to_numpy(pcache)
    for name in jcache:
        _close(torch.from_numpy(back[name]), jcache[name])


def test_loss_matches_jax(pair):
    jc, params, pc, model = pair
    toks, labels = _tokens(jc, 2, S), _tokens(jc, 2, S, seed=1)
    want = jlm.loss_fn(jc, params, {"tokens": jnp.asarray(toks),
                                    "labels": jnp.asarray(labels)})
    got = plm.loss_fn(pc, model, {"tokens": torch.from_numpy(toks),
                                  "labels": torch.from_numpy(labels)})
    _close(got, want)


def test_prefill_matches_incremental_decode(pair):
    """``serve.check_consistency`` (MoE without capacity drops)."""
    _, _, pc, model = pair
    prompt = serve.make_prompts(pc, 2, 24, 1, "cpu")
    assert serve.check_consistency(pc, model, prompt) < serve.CONSISTENCY_TOL


def test_moe_prefill_differs_from_decode_under_drops():
    """Why the check lifts the capacity: at the published 1.25 a 48-token
    prefill drops slots that one-token decode steps (capacity 4) keep,
    in the JAX package as in the port."""
    cfg = pconfigs.get_smoke_config("granite-moe-3b-a800m")
    model = serve.build_model(cfg, 0, "cpu")
    prompt = serve.make_prompts(cfg, 2, 24, 1, "cpu")
    b, s = prompt.shape
    logits_p, _ = plm.prefill(cfg, model, {"tokens": prompt},
                              cache=plm.init_cache(cfg, b, s, device="cpu"))
    cache = plm.init_cache(cfg, b, s, device="cpu")
    for t in range(s):
        logits_i, cache = plm.decode_step(cfg, model, cache, prompt[:, t], t)
    assert float((logits_p - logits_i).abs().max()) > 1e-3
    assert serve.check_consistency(cfg, model, prompt) < 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_match_jax(arch):
    for get in ("get_config", "get_smoke_config"):
        jc = getattr(jconfigs, get)(arch)
        pc = getattr(pconfigs, get)(arch)
        assert _asdict(pc) == _asdict(jc)
        assert pc.param_count() == jc.param_count()
        assert pc.param_count(padded=True) == jc.param_count(padded=True)
        assert pc.windows() == jc.windows()
        if pc.n_heads:
            assert pc.head_map == jc.head_map


@pytest.mark.parametrize("arch", ARCHS)
def test_leaves_match_jax_tree(arch):
    """Names, shapes and dtypes of every leaf equal the JAX tree's in
    bf16, at full width and two layers (``meta`` device: no
    allocation): the router and Mamba's vectors stay f32."""
    jc = jconfigs.get_config(arch).replace(n_layers=2)
    pc = pconfigs.get_config(arch).replace(n_layers=2)
    shapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                          jlm.param_shapes(jc.replace(param_dtype="bfloat16")))
    model = plm.LM(pc, device="meta", dtype=torch.bfloat16)
    got = {name: ((pc.n_layers, *segs[0].shape) if name.startswith("layers.")
                  else tuple(segs[0].shape), str(segs[0].dtype))
           for name, segs in plm.param_leaves(model.named_parameters())}
    want = {".".join(str(k.key) for k in path): (tuple(s), d)
            for path, (s, d) in jax.tree_util.tree_leaves_with_path(
                shapes, is_leaf=lambda x: isinstance(x, tuple)
                and len(x) == 2 and isinstance(x[1], str))}
    assert set(got) == set(want)
    for name, (shape, dt) in want.items():
        assert got[name][0] == shape, name
        assert got[name][1] == "torch." + dt, name


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_initialisers_and_seeding(arch):
    cfg = pconfigs.get_smoke_config(arch)
    a = serve.build_model(cfg, 0, "cpu")
    b = serve.build_model(cfg, 0, "cpu", torch.bfloat16)
    sa, sb = a.state_dict(), b.state_dict()
    for k in sa:
        if k.rsplit(".", 1)[-1] in plm.F32_LEAVES:
            assert sb[k].dtype == torch.float32 and torch.equal(sa[k], sb[k])
        else:
            assert sb[k].dtype == torch.bfloat16
            assert torch.equal(sa[k].to(torch.bfloat16), sb[k]), k
    c = plm.cast(serve.build_model(cfg, 0, "cpu"), torch.bfloat16)
    assert all(torch.equal(v, c.state_dict()[k]) for k, v in sb.items())
    # param_count covers the projection matrices and the router, not the
    # norms, biases and Mamba's convolution taps and vectors
    skip = ("conv_x", "conv_B", "conv_C")
    assert sum(p.numel() for n, p in a.named_parameters()
               if p.dim() >= 2 and n.rsplit(".", 1)[-1] not in skip) == \
        cfg.param_count()
    lp = a.layers[0]
    if hasattr(lp, "mamba"):
        nh = lp.mamba.A_log.shape[0]
        assert torch.equal(lp.mamba.A_log,
                           torch.log(torch.linspace(1.0, 16.0, nh)))
        assert bool((lp.mamba.D == 1).all())
        assert not bool(lp.mamba.dt_bias.any())
        assert float(lp.mamba.conv_x.std()) == pytest.approx(0.1, rel=0.3)
    if hasattr(lp, "moe"):
        assert lp.moe.router.dtype == torch.float32
    c1 = serve.build_model(cfg, 1, "cpu")
    assert not torch.equal(sa["embed"], c1.state_dict()["embed"])
    # a shallower model is the first layers of a deeper one
    short = serve.build_model(cfg.replace(n_layers=1), 0, "cpu")
    assert all(torch.equal(v, sa[k]) for k, v in short.state_dict().items())


def test_padded_experts_and_heads_are_zero():
    cfg = pconfigs.get_smoke_config("granite-moe-3b-a800m")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts_padded=12))
    moe = serve.build_model(cfg, 0, "cpu").layers[0].moe
    for w in (moe.w_gate, moe.w_up, moe.w_down):
        assert not bool(w[8:].any()) and bool(w[:8].any())
    cfg = pconfigs.get_smoke_config("minicpm3-4b").replace(tp_pad=3)
    attn = serve.build_model(cfg, 0, "cpu").layers[0].attn
    assert cfg.n_heads_padded == 6
    assert not bool(attn.w_uq[:, 4:].any()) and not bool(attn.wo[4:].any())


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

# (name, (B, S), dispatch_chunk, capacity_factor, n_experts_padded)
MOE_CASES = (
    ("one-chunk", (2, 16), 4096, 1.25, 0),
    ("chunks", (2, 16), 8, 1.25, 0),
    ("ragged-one-chunk", (3, 5), 4, 1.25, 0),
    ("drops", (2, 16), 8, 0.5, 0),
    ("padded", (2, 16), 8, 1.25, 12),
)


@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_fwd_matches_jax(case):
    name, (b, s), chunk, cf, e_pad = case
    d = 32
    jmo = jmoe.MoEConfig(n_experts=8, top_k=2, d_expert=24,
                         n_experts_padded=e_pad, capacity_factor=cf,
                         dispatch_chunk=chunk)
    pmo = pmoe.MoEConfig(**dataclasses.asdict(jmo))
    tree = jax.tree.map(np.asarray, jmoe.init_moe(
        jax.random.PRNGKey(3), d_model=d, mo=jmo, dtype=jnp.float32))
    p = _load(pmoe.MoE(d, pmo, dtype=torch.float32, device="cpu"), tree)
    x = _normal((b, s, d), 7)

    # the chosen experts, token by token (top-k is per token)
    xt = x.reshape(-1, d)
    jlog = np.array(jnp.asarray(xt) @ jnp.asarray(tree["router"]))
    if e_pad > 8:
        jlog[:, 8:] = -np.inf
    _, jidx = jax.lax.top_k(jnp.asarray(jlog), jmo.top_k)
    _, pidx = pmoe.router_top_k(p, _t(xt), pmo)
    srt = np.sort(jlog, axis=-1)[:, ::-1]
    ties = np.flatnonzero(srt[:, jmo.top_k - 1] - srt[:, jmo.top_k]
                          < TIE_GAP)
    if len(ties):
        print(f"moe {name}: {len(ties)} near-tied tokens {ties.tolist()}")
    same = np.all(np.sort(np.asarray(jidx), -1)
                  == np.sort(pidx.numpy(), -1), axis=-1)
    assert bool(same[np.setdiff1d(np.arange(len(xt)), ties)].all())
    assert int(pidx.max()) < 8

    nc = 1 if (b * s) % min(chunk, b * s) else (b * s) // min(chunk, b * s)
    assert nc == {"one-chunk": 1, "chunks": 4, "ragged-one-chunk": 1,
                  "drops": 4, "padded": 4}[name]
    if name == "drops":  # some expert overflows its chunk's capacity
        cap = jmo.capacity(b * s // nc)
        load = [np.bincount(r, minlength=8).max() for r in
                np.asarray(jidx).reshape(nc, -1)]
        assert max(load) > cap
    want = jmoe.moe_fwd(tree, jnp.asarray(x), mo=jmo)
    got = pmoe.moe_fwd(p, _t(x), mo=pmo)
    keep = np.setdiff1d(np.arange(b * s), ties)
    _close(got.reshape(-1, d)[keep], np.asarray(want).reshape(-1, d)[keep])


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------

# (name, l, chunk, h, g, with an initial state)
SSD_CASES = (
    ("ragged", 37, 8, 4, 1, False),
    ("init-state", 32, 8, 4, 1, True),
    ("groups", 29, 8, 4, 2, False),
    ("short", 5, 16, 2, 1, True),
)


@pytest.mark.parametrize("case", SSD_CASES, ids=[c[0] for c in SSD_CASES])
def test_ssd_chunked_matches_jax(case):
    _, l, chunk, h, g, init = case
    b, p, n = 2, 6, 5
    x = _normal((b, l, h, p), 1)
    dt = np.log1p(np.exp(_normal((b, l, h), 2))).astype(np.float32)
    A = -np.exp(_normal((h,), 3, 0.5))
    B, C = _normal((b, l, g, n), 4), _normal((b, l, g, n), 5)
    D = _normal((h,), 6)
    s0 = _normal((b, h, p, n), 7) if init else None
    jy, jfinal = jmamba.ssd_chunked(
        *(jnp.asarray(a) for a in (x, dt, A, B, C, D)), chunk,
        init_state=None if s0 is None else jnp.asarray(s0))
    py, pfinal = pmamba.ssd_chunked(
        *(_t(a) for a in (x, dt, A, B, C, D)), chunk,
        init_state=None if s0 is None else _t(s0))
    assert tuple(py.shape) == (b, l, h, p)
    _close(py, jy)
    _close(pfinal, jfinal)


_JMAMBA = jax.jit(jmamba.mamba_fwd, static_argnames=("mc", "d_model"))
_JMLA = jax.jit(jattn.mla_fwd, static_argnames=("qk_nope", "qk_rope",
                                                "rope_theta"))


def _mamba_pair(seed=0):
    mc = jmamba.MambaConfig(d_state=8, head_dim=8, n_groups=2, expand=2,
                            chunk=8)
    d = 16
    tree = jax.tree.map(np.asarray, jmamba.init_mamba(
        jax.random.PRNGKey(seed), d_model=d, mc=mc, dtype=jnp.float32))
    pmc = pmamba.MambaConfig(**dataclasses.asdict(mc))
    p = _load(pmamba.Mamba(d, pmc, dtype=torch.float32, device="cpu"), tree)
    return mc, pmc, d, tree, p


def test_mamba_fwd_full_prefill_and_decode_match_jax():
    mc, pmc, d, tree, p = _mamba_pair()
    b, s = 2, 13
    x = _normal((b, s + 3, d), 11)
    # full sequence, no cache
    want, jc = _JMAMBA(tree, jnp.asarray(x), mc=mc, d_model=d)
    got, pc = pmamba.mamba_fwd(p, _t(x), mc=pmc, d_model=d)
    assert jc is None and pc is None
    _close(got, want)
    # prefill of s tokens into a fresh cache, then 3 decode tokens
    jcache = jmamba.init_mamba_cache(b, d, mc, jnp.float32)
    pcache = pmamba.init_mamba_cache(b, d, pmc, torch.float32, "cpu")
    steps_ = [x[:, :s]] + [x[:, s + i:s + i + 1] for i in range(3)]
    for xs in steps_:
        want, jcache = _JMAMBA(tree, jnp.asarray(xs), mc=mc, d_model=d,
                               cache=jcache)
        got, pcache = pmamba.mamba_fwd(p, _t(xs), mc=pmc, d_model=d,
                                       cache=pcache)
        _close(got, want)
        assert set(pcache) == set(jcache)
        for name in jcache:
            _close(pcache[name], jcache[name])
    # decoding token by token equals the full sequence
    full, _ = pmamba.mamba_fwd(p, _t(x), mc=pmc, d_model=d)
    _close(got[:, 0], full[:, -1].numpy())


def test_mamba_cache_keeps_pre_convolution_tail():
    _, pmc, d, _, p = _mamba_pair(1)
    x = _t(_normal((1, 2, d), 4))
    cache = pmamba.init_mamba_cache(1, d, pmc, torch.float32, "cpu")
    pmamba.mamba_fwd(p, x, mc=pmc, d_model=d, cache=cache)
    xr = x @ p.w_x
    assert bool((cache["conv_x"][:, 0] == 0).all())  # before the prompt
    assert torch.equal(cache["conv_x"][:, 1:], xr)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def test_mla_fwd_prefill_and_decodes_match_jax():
    kw = dict(q_lora=12, kv_lora=10, qk_nope=8, qk_rope=4, v_dim=6)
    d, h, h_pad = 16, 3, 4
    tree = jax.tree.map(np.asarray, jattn.init_mla(
        jax.random.PRNGKey(5), d_model=d, n_heads_padded=h_pad, n_heads=h,
        dtype=jnp.float32, **kw))
    p = _load(pattn.MLA(d_model=d, n_heads_padded=h_pad, dtype=torch.float32,
                        device="cpu", **kw), tree)
    rope = dict(qk_nope=kw["qk_nope"], qk_rope=kw["qk_rope"],
                rope_theta=1e4)
    b, s, smax = 2, 9, 12
    x = _normal((b, s + 3, d), 9)
    want, _ = _JMLA(tree, jnp.asarray(x), positions=jnp.arange(s + 3),
                    **rope)
    got, _ = pattn.mla_fwd(p, _t(x), positions=torch.arange(s + 3), **rope)
    _close(got, want)
    jcache = {"ckv": jnp.zeros((b, smax, kw["kv_lora"])),
              "kr": jnp.zeros((b, smax, kw["qk_rope"]))}
    pcache = {k: torch.zeros(v.shape) for k, v in jcache.items()}
    want, jcache = _JMLA(tree, jnp.asarray(x[:, :s]),
                         positions=jnp.arange(s), cache=jcache,
                         cache_pos=jnp.int32(0), **rope)
    got, pcache = pattn.mla_fwd(p, _t(x[:, :s]), positions=torch.arange(s),
                                cache=pcache, cache_pos=0, **rope)
    _close(got, want)
    for t in range(s, s + 3):
        pos = np.full((b, 1), t, np.int32)
        want, jcache = _JMLA(
            tree, jnp.asarray(x[:, t:t + 1]), positions=jnp.asarray(pos),
            cache=jcache, cache_pos=jnp.int32(t), **rope)
        got, pcache = pattn.mla_fwd(
            p, _t(x[:, t:t + 1]), positions=torch.from_numpy(pos),
            cache=pcache, cache_pos=t, **rope)
        _close(got, want)
        for name in ("ckv", "kr"):
            _close(pcache[name], jcache[name])


# ---------------------------------------------------------------------------
# Serving and training entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serving_steps_in_bf16(arch):
    cfg = pconfigs.get_smoke_config(arch)
    scfg = steps.StepConfig()
    model = plm.cast(serve.build_model(cfg, 0, "cpu"), torch.bfloat16)
    prefill = steps.make_prefill_step(cfg, scfg, seq_len=8, batch=2,
                                      device="cpu")
    decode = steps.make_decode_step(cfg, scfg, seq_len=12, batch=2,
                                    device="cpu")
    cache = steps.make_cache(cfg, scfg, batch=2, max_len=12, device="cpu")
    assert all(t.dtype == torch.bfloat16 and t.shape[:2] ==
               (cfg.n_layers, 2) for t in cache.values())
    toks = serve.make_prompts(cfg, 2, 8, 0, "cpu")
    logits, cache = prefill(model, toks, cache)
    assert logits.shape == (2, cfg.vocab_padded)
    assert logits.dtype == torch.float32
    assert bool(torch.isfinite(logits[:, :cfg.vocab]).all())
    for name in ("k", "ckv", "state"):
        if name in cache:
            assert bool(cache[name].abs().gt(0).any())
    logits, cache = decode(model, cache, logits.argmax(-1), 8)
    assert bool(torch.isfinite(logits[:, :cfg.vocab]).all())
    bad = {k: v[:, :1] for k, v in cache.items()}
    with pytest.raises(ValueError, match="does not hold"):
        decode(model, bad, toks[:, 0], 9)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--prompt-len", "16", "--gen", "4",
                       "--batch", "2"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["arch"] == arch + "-smoke" and rec["device"] == "cpu"
    assert np.array(rec["tokens"]).shape == (2, 4)
    assert rec["prefill_decode_max_abs_err"] < serve.CONSISTENCY_TOL
    assert rec["check_layers"] == pconfigs.get_smoke_config(arch).n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_refuses_new_families(arch, capsys, tmp_path):
    """The families train now: one step of each family's training CLI."""
    assert ptrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--steps", "1", "--seq-len", "32",
                        "--ckpt-dir", str(tmp_path)]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["arch"] == arch + "-smoke" and rec["steps"] == 1
    assert np.isfinite(rec["losses"]).all()
    assert rec["sync_all_reduces_last_step"] > 1
