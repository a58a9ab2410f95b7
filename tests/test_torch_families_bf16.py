"""Every architecture's smoke config in bf16 against the JAX package, and
the Hymba hybrid's sliding window in f32.

bf16: the JAX package's ``init_params(PRNGKey(0))`` with
``param_dtype="bfloat16"`` (the router and Mamba's ``A_log``/``D``/
``dt_bias`` stay f32) is carried across and cast with ``lm.cast``; a
prefill of 2 x 24 tokens into a longer cache, then 3 greedy decode steps
fed JAX's tokens (musicgen: seeded frames).  The logits of every prefill
position and of every decode step must equal JAX's within ``ULPS`` bf16
ulps at the logit scale (the ulp of the largest |logit| of the array:
0.0156 at |logit| 2-4); the reached gaps are 1-4 ulps.

MoE: a token whose router logits put the k-th and (k+1)-th experts
within one bf16 ulp of the router-logit scale (the ulp of the row's
largest |logit|) is a near-tie: the two packages' bf16 hidden states
differ by an ulp here and there, and may order it either way.  A tie
that goes the other way also moves, by one slot, the capacity position
of every later token of its dispatch chunk on the two experts, so a
later token whose slot sits at the capacity can be kept in one package
and dropped in the other: a capacity dependent.  Only those tokens
(counted on the port's router, any layer) are exempt, and the test
prints their counts, held to those of this seed (``EXEMPT``).  Every
prefill token whose experts differ between the two packages must be a
counted near-tie, and there JAX's router in f32, on the same weights,
must pick one of the two packages' sets: a second witness that the
bf16 rounding decides a tie.  moonshot's smoke prefill has 3 near-ties
and 4 dependents of 48 tokens; one near-tie (the last token of the
first row) routes differently in the two packages, its router gap
being 2 ulps at the k-th logit in JAX and 3 in the port, under one ulp
at the row's scale; JAX in f32 takes JAX's experts there.  One of its
dependents (row 2, position 2) is dropped in one package only.

The window: hymba at 4 and 5 layers (window 8 on the layers other than
the first, middle and last) over a prefill of 24 tokens and 12 decode
steps, logits and every cache entry within 1e-4 of JAX in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro_torch import configs as pconfigs
from repro_torch.models import convert, lm as plm, moe as pmoe

B, S, GEN = 2, 24, 3
ULPS = 5
# (near-tie tokens, capacity dependents) over the prefill and decodes of
# this seed; an MoE arch not listed has none.
EXEMPT = {"granite-moe-3b-a800m": (1, 4), "moonshot-v1-16b-a3b": (4, 4)}


def bf16_ulp(x):
    """The bf16 ulp at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _inputs(cfg, rng):
    if cfg.frontend == "audio_stub":
        batch = {"embeds": rng.standard_normal((B, S, cfg.d_model),
                                               dtype=np.float32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = rng.standard_normal((B, 8, cfg.d_model),
                                                    dtype=np.float32)
    return batch


@pytest.fixture
def router_log(monkeypatch):
    """The port's routing, one record per ``router_top_k`` call in call
    order: (router logits (T, n_experts) f32, top-k ids (T, k), each
    slot's position in its expert's capacity buffer (T, k), capacity)."""
    rec = []
    real = pmoe.router_top_k

    def spy(p, xc, mo):
        vals, idx = real(p, xc, mo)
        logits = (xc @ p.router.to(xc.dtype)).float()[:, :mo.n_experts]
        flat = idx.reshape(-1)
        onehot = (torch.arange(mo.e_pad)[:, None] == flat[None, :]).int()
        pos = (onehot.cumsum(dim=1) - 1).gather(0, flat[None, :])[0]
        rec.append((logits.numpy(), idx.numpy(),
                    pos.reshape(idx.shape).numpy(), mo.capacity(len(xc))))
        return vals, idx
    monkeypatch.setattr(pmoe, "router_top_k", spy)
    return rec


@pytest.fixture
def jax_routing(monkeypatch):
    """JAX's routing, one top-k id array (T, k) per ``jax.lax.top_k``
    call in call order (the MoE router's, the forward's only top-k),
    read back from inside scans by a debug callback."""
    rec = []
    real = jax.lax.top_k

    def spy(x, k):
        vals, idx = real(x, k)
        jax.debug.callback(lambda ids: rec.append(np.asarray(ids)), idx,
                           ordered=True)
        return vals, idx
    monkeypatch.setattr(jax.lax, "top_k", spy)
    return rec


def _routes(rec):
    """Each call's expert set per token, as sorted ids (T, k)."""
    jax.effects_barrier()
    out = [np.sort(r, axis=-1) for r in rec]
    rec.clear()
    return out


def near_ties(rec, k: int):
    """(near-tie rows, capacity dependents) over the recorded calls.  A
    near-tie row's k-th and (k+1)-th router logits lie within one bf16
    ulp of the row's largest |logit|, so it may take either expert.  A
    dependent is a later row of the same call with a slot on one of the
    tied experts within that many slots of the capacity: if the tie
    goes the other way, its slot moves across the capacity and is kept
    in one package and dropped in the other."""
    ties, deps = set(), set()
    for logits, idx, pos, cap in rec:
        order = np.argsort(-logits, axis=-1, kind="stable")
        srt = np.take_along_axis(logits, order, axis=-1)
        gap = srt[:, k - 1] - srt[:, k]
        rows = np.flatnonzero(gap <= bf16_ulp(np.abs(logits).max(-1)))
        ties |= set(rows.tolist())
        for u in range(len(idx)):
            earlier = rows[rows < u]
            tied = order[earlier][:, [k - 1, k]]
            for j in range(k):
                m = int((tied == idx[u, j]).any(-1).sum())
                if m and cap - m <= pos[u, j] < cap + m:
                    deps.add(u)
    rec.clear()
    return ties, deps - ties


def _within(got, want, keep, what):
    """|got - want| within ``ULPS`` ulps of the logit scale on the rows
    ``keep``; returns the reached gap in ulps."""
    scale = bf16_ulp(np.abs(want).max())
    d = np.abs(got - want).reshape(len(got), -1).max(-1)
    reached = float(d[keep].max() / scale) if len(keep) else 0.0
    assert reached <= ULPS, (f"{what}: {reached:.2f} ulps (ulp {scale}) at"
                             f" rows {np.flatnonzero(d / scale > ULPS)}")
    return reached


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCH_IDS))
def test_bf16_prefill_and_decodes_match_jax(arch, router_log, jax_routing):
    jc = jconfigs.get_smoke_config(arch).replace(param_dtype="bfloat16")
    pc = pconfigs.get_smoke_config(arch).replace(param_dtype="bfloat16")
    params = jlm.init_params(jc, jax.random.PRNGKey(0))
    as_f32 = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                          params)
    model = plm.cast(convert.params_from_jax(
        as_f32, pc.replace(param_dtype="float32"), device="cpu"),
        torch.bfloat16)
    for name, p in model.named_parameters():
        f32 = name.rsplit(".", 1)[-1] in plm.F32_LEAVES
        assert p.dtype == (torch.float32 if f32 else torch.bfloat16), name
    rng = np.random.default_rng(0)
    batch = _inputs(jc, rng)
    k = pc.moe.top_k if pc.moe is not None else 0

    # prefill: the logits of every position
    jh, jcache = jlm.forward(jc, params,
                             {n: jnp.asarray(v) for n, v in batch.items()},
                             cache=jlm.init_cache(jc, B, S + GEN),
                             cache_pos=jnp.int32(0))
    want = np.asarray((jh @ jlm.output_head(jc, params))
                      .astype(jnp.float32))[..., :jc.vocab]
    ph, pcache = plm.forward(pc, model,
                             {n: torch.from_numpy(v)
                              for n, v in batch.items()},
                             cache=plm.init_cache(pc, B, S + GEN,
                                                  device="cpu"),
                             cache_pos=0)
    got = (ph @ plm.output_head(pc, model)).float().numpy()[..., :jc.vocab]
    jroutes = _routes(jax_routing)
    proutes = [np.sort(idx, axis=-1) for _, idx, _, _ in router_log]
    ties, deps = near_ties(router_log, k) if k else (set(), set())
    flipped = set()
    if k:
        # the tokens routed differently: counted near-ties, each with
        # JAX's f32 router on one of the two sides
        jlm.forward(jc.replace(param_dtype="float32"),
                    jax.tree.map(jnp.asarray, as_f32),
                    {n: jnp.asarray(v) for n, v in batch.items()},
                    cache=jlm.init_cache(jc.replace(param_dtype="float32"),
                                         B, S + GEN),
                    cache_pos=jnp.int32(0))
        f32routes = _routes(jax_routing)
        assert len(jroutes) == len(proutes) == len(f32routes) == jc.n_layers
        for jr, pr, fr in zip(jroutes, proutes, f32routes):
            for u in np.flatnonzero((jr != pr).any(-1)):
                assert u in ties, f"{arch}: token {u} routed differently," \
                    f" not a near-tie"
                assert (fr[u] == jr[u]).all() or (fr[u] == pr[u]).all(), \
                    f"{arch}: token {u} in f32 takes {fr[u]}, JAX bf16" \
                    f" {jr[u]}, the port {pr[u]}"
                flipped.add(int(u))
    keep = np.setdiff1d(np.arange(B * S), sorted(ties | deps))
    reached = [_within(got.reshape(B * S, -1), want.reshape(B * S, -1),
                       keep, f"{arch} prefill")]

    # three decode steps, fed JAX's greedy tokens
    jl = want[:, -1]
    n_ties, n_deps = len(ties), len(deps)
    for t in range(GEN):
        tok = np.argmax(jl, -1).astype(np.int32)
        e = (rng.standard_normal((B, 1, jc.d_model), dtype=np.float32)
             if jc.frontend == "audio_stub" else None)
        jl, jcache = jlm.decode_step(
            jc, params, jcache, jnp.asarray(tok), jnp.int32(S + t),
            embeds=None if e is None else jnp.asarray(e))
        pl, pcache = plm.decode_step(
            pc, model, pcache, torch.from_numpy(tok), S + t,
            embeds=None if e is None else torch.from_numpy(e))
        jl = np.asarray(jl)[:, :jc.vocab]
        jax_routing.clear()
        dties, ddeps = near_ties(router_log, k) if k else (set(), set())
        n_ties, n_deps = n_ties + len(dties), n_deps + len(ddeps)
        reached.append(_within(pl.numpy()[:, :jc.vocab], jl,
                               np.setdiff1d(np.arange(B),
                                            sorted(dties | ddeps)),
                               f"{arch} decode {t}"))
    print(f"{arch} bf16: reached {[round(r, 2) for r in reached]} ulps;"
          f" exempt: {n_ties} MoE near-tie tokens"
          f"{' ' + str(sorted(ties)) if ties else ''} and {n_deps} capacity"
          f" dependents{' ' + str(sorted(deps)) if deps else ''}; routed"
          f" differently in prefill: {sorted(flipped)}")
    max_ties, max_deps = EXEMPT.get(arch, (0, 0))
    assert n_ties <= max_ties and n_deps <= max_deps, (n_ties, n_deps)
    if arch == "moonshot-v1-16b-a3b":
        # the last token of the first row routes differently in the two
        # packages: a counted near-tie
        assert flipped == {23}


@pytest.mark.parametrize("n_layers", [4, 5])
def test_hybrid_window_matches_jax(n_layers):
    """hymba with windowed layers: window 8 on all layers but the first,
    middle and last; a 24-token prefill and 12 decode steps."""
    jc = jconfigs.get_smoke_config("hymba-1.5b").replace(n_layers=n_layers)
    pc = pconfigs.get_smoke_config("hymba-1.5b").replace(n_layers=n_layers)
    windows = pc.windows()
    assert windows == jc.windows() and jc.window_size == 8
    assert sum(w > 0 for w in windows) == n_layers - 3
    params = jlm.init_params(jc, jax.random.PRNGKey(0))
    model = convert.params_from_jax(jax.tree.map(np.asarray, params), pc,
                                    device="cpu")
    gen = 12
    toks = np.random.default_rng(3).integers(0, jc.vocab, (B, S)).astype(
        np.int32)
    jl, jcache = jlm.prefill(jc, params, {"tokens": jnp.asarray(toks)},
                             cache=jlm.init_cache(jc, B, S + gen))
    pl, pcache = plm.prefill(pc, model, {"tokens": torch.from_numpy(toks)},
                             cache=plm.init_cache(pc, B, S + gen,
                                                  device="cpu"))

    def close(a, b):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b),
                                   rtol=1e-4, atol=1e-4)
    close(pl, jl)
    for t in range(gen):
        tok = np.argmax(np.asarray(jl)[:, :jc.vocab], -1).astype(np.int32)
        jl, jcache = jlm.decode_step(jc, params, jcache, jnp.asarray(tok),
                                     jnp.int32(S + t))
        pl, pcache = plm.decode_step(pc, model, pcache,
                                     torch.from_numpy(tok), S + t)
        close(pl, jl)
    for name in jcache:
        close(pcache[name], jcache[name])
