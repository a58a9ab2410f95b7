"""The port's serving path against the JAX package's language model.

For the dense-GQA smoke configs (llama3.2-1b, gemma2-9b, qwen2-7b) the
JAX package's ``init_params(PRNGKey(0))`` is carried across with
``convert.params_from_jax``; the port's ``forward``, ``prefill`` (logits
and cache) and ``decode_step`` must then equal ``repro.models.lm`` in f32
within 1e-4.  On the CPU the prefill's attention runs the flash kernel's
plain version.  Also: the layers against their JAX counterparts, the
configs field for field, prefill against incremental decode, the serving
steps and the ``python -m repro_torch.serve`` command line.
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

ARCHS = ("llama3.2-1b", "gemma2-9b", "qwen2-7b")
TOL = 1e-4
S, GEN = 24, 4


def _asdict(cfg):
    return {k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
            for k, v in ((f.name, getattr(cfg, f.name))
                         for f in dataclasses.fields(cfg))}


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


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


def test_forward_matches_jax(pair):
    jc, params, pc, model = pair
    toks = _tokens(jc, 2, S)
    want, _ = jlm.forward(jc, params, {"tokens": jnp.asarray(toks)})
    got, cache = plm.forward(pc, model, {"tokens": torch.from_numpy(toks)})
    assert cache is None
    _close(got, want)


def test_prefill_and_decode_match_jax(pair):
    """Prefill into a cache longer than the prompt (the flash path reads
    the new keys only), then one decode step."""
    jc, params, pc, model = pair
    toks = _tokens(jc, 2, S)
    jl, jcache = jlm.prefill(jc, params, {"tokens": jnp.asarray(toks)},
                             cache=jlm.init_cache(jc, 2, S + GEN))
    pl, pcache = plm.prefill(pc, model, {"tokens": torch.from_numpy(toks)},
                             cache=plm.init_cache(pc, 2, S + GEN,
                                                  device="cpu"))
    _close(pl, jl)
    for name in ("k", "v"):
        _close(pcache[name], jcache[name])
    tok = np.argmax(np.asarray(jl)[:, :jc.vocab], -1).astype(np.int32)
    jl2, jcache2 = jlm.decode_step(jc, params, jcache, jnp.asarray(tok),
                                   jnp.int32(S))
    pl2, pcache2 = plm.decode_step(pc, model, pcache, torch.from_numpy(tok),
                                   S)
    _close(pl2, jl2)
    _close(pcache2["k"], jcache2["k"])


def test_prefill_without_flash_equals_flash_plain(pair):
    """``flash=False`` (masked_attention) and the flash plain version
    give the same prefill in f32."""
    _, _, pc, model = pair
    toks = torch.from_numpy(_tokens(pc, 2, S, seed=1))
    a, _ = plm.prefill(pc, model, {"tokens": toks})
    b, _ = plm.prefill(pc, model, {"tokens": toks}, flash=False)
    _close(a, b.numpy())


def test_cache_round_trip_from_jax(pair):
    jc, params, pc, model = pair
    toks = _tokens(jc, 2, S)
    _, jcache = jlm.prefill(jc, params, {"tokens": jnp.asarray(toks)},
                            cache=jlm.init_cache(jc, 2, S + GEN))
    pcache = convert.cache_from_jax(jax.tree.map(np.asarray, jcache),
                                    device="cpu")
    tok = np.zeros(2, np.int32)
    jl, _ = jlm.decode_step(jc, params, jcache, jnp.asarray(tok),
                            jnp.int32(S))
    pl, pcache = plm.decode_step(pc, model, pcache, torch.from_numpy(tok), S)
    _close(pl, jl)
    assert convert.cache_to_numpy(pcache)["k"].shape == jcache["k"].shape


def test_prefill_matches_incremental_decode(pair):
    _, _, pc, model = pair
    prompt = serve.make_prompts(pc, 2, 24, 1, "cpu")
    assert serve.check_consistency(pc, model, prompt) < serve.CONSISTENCY_TOL


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
        assert pc.replace(tp_pad=16).param_count(padded=True) == \
            jc.with_tp(16).param_count(padded=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_counts_and_seeding(arch):
    cfg = pconfigs.get_smoke_config(arch)
    a = serve.build_model(cfg, 0, "cpu")
    b = serve.build_model(cfg, 0, "cpu")
    c = serve.build_model(cfg, 1, "cpu")
    # param_count covers the matrices: no norm scales, no biases
    assert sum(p.numel() for n, p in a.named_parameters()
               if p.dim() >= 2 and n[-2:] not in ("bq", "bk", "bv")) == \
        cfg.param_count()
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["layers.0.attn.wq"], sc["layers.0.attn.wq"])
    norm = 0.0 if cfg.zero_centered_norm else 1.0
    assert bool((sa["final_norm"] == norm).all())
    # fan-in truncated normal: within two standard deviations
    wq = sa["layers.0.attn.wq"]
    assert float(wq.abs().max()) <= 2.0 / cfg.d_model ** 0.5


def test_unported_archs_and_blocks_raise():
    """Nothing is left unported: the port's ARCH_IDS are the reference's,
    and the blocks that raised before (M-RoPE, a stub frontend) build."""
    assert set(pconfigs.ARCH_IDS) == set(jconfigs.ARCH_IDS)
    assert not hasattr(pconfigs, "NOT_PORTED")
    for arch in ("qwen2-vl-7b", "musicgen-medium"):
        assert pconfigs.get_config(arch).name == arch
    llama = pconfigs.get_smoke_config("llama3.2-1b")
    for cfg in (llama.replace(mrope_sections=(2, 3, 3)),
                llama.replace(frontend="audio_stub")):
        model = plm.LM(cfg, device="cpu")
        assert len(model.layers) == cfg.n_layers


def test_convert_rejects_mismatched_trees():
    jc = jconfigs.get_smoke_config("llama3.2-1b")
    tree = jax.tree.map(np.asarray, jlm.init_params(jc, jax.random.PRNGKey(0)))
    pc = pconfigs.get_smoke_config("qwen2-7b")
    with pytest.raises(ValueError, match="differ|shape"):
        convert.params_from_jax(tree, pc, device="cpu")


@pytest.mark.parametrize("zc", [False, True])
def test_layers_match_jax(zc):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    _close(players.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                            zero_centered=zc),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale),
                            zero_centered=zc))
    _close(players.softcap(torch.from_numpy(x) * 40, 30.0),
           jlayers.softcap(jnp.asarray(x) * 40, 30.0))
    _close(players.silu(torch.from_numpy(x)), jlayers.silu(jnp.asarray(x)))
    for pos in (np.arange(6), np.array([[3], [9]])):
        xs = x[:, :pos.shape[-1]]
        _close(players.apply_rope(torch.from_numpy(xs), torch.from_numpy(pos),
                                  5e5),
               jlayers.apply_rope(jnp.asarray(xs), jnp.asarray(pos), 5e5))
    # M-RoPE needs (3, ..., S) positions, in JAX as in the port
    with pytest.raises(AssertionError, match="M-RoPE"):
        players.apply_rope(torch.from_numpy(x), torch.arange(6), 1e4,
                           (2, 3, 3))
    with pytest.raises(AssertionError, match="M-RoPE"):
        jlayers.apply_rope(jnp.asarray(x), jnp.arange(6), 1e4, (2, 3, 3))


def test_serving_steps_check_inputs():
    cfg = pconfigs.get_smoke_config("llama3.2-1b")
    scfg = steps.StepConfig()
    model = serve.build_model(cfg, 0, "cpu").to(torch.bfloat16)
    prefill = steps.make_prefill_step(cfg, scfg, seq_len=8, batch=2,
                                      device="cpu")
    decode = steps.make_decode_step(cfg, scfg, seq_len=12, batch=2,
                                    device="cpu")
    cache = steps.make_cache(cfg, scfg, batch=2, max_len=12, device="cpu")
    assert cache["k"].dtype == torch.bfloat16
    toks = serve.make_prompts(cfg, 2, 8, 0, "cpu")
    logits, cache = prefill(model, toks, cache)
    assert logits.shape == (2, cfg.vocab) and logits.dtype == torch.float32
    assert bool(cache["k"][:, :, :8].abs().sum(-1).gt(0).all())
    assert not bool(cache["k"][:, :, 8:].any())
    logits, cache = decode(model, cache, logits.argmax(-1), 8)
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match="prefill_step"):
        prefill(model, toks[:, :4], cache)
    with pytest.raises(ValueError, match="outside the cache"):
        decode(model, cache, toks[:, 0], 12)
    with pytest.raises(ValueError, match="does not hold"):
        prefill(model, toks, steps.make_cache(cfg, scfg, batch=2, max_len=4,
                                              device="cpu"))


def test_cuda_default_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    cfg = pconfigs.get_smoke_config("llama3.2-1b")
    with pytest.raises(RuntimeError, match="cuda"):
        plm.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.build_model(cfg, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--smoke"])


def test_serve_cli_on_cpu(capsys):
    assert serve.main(["--smoke", "--device", "cpu", "--prompt-len", "16",
                       "--gen", "4", "--batch", "2"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["arch"] == "llama3.2-1b-smoke" and rec["device"] == "cpu"
    assert np.array(rec["tokens"]).shape == (2, 4)
    assert rec["prefill_decode_max_abs_err"] < serve.CONSISTENCY_TOL
