"""The tensor- and expert-parallel serving forward on ``gloo`` ranks in
subprocesses (this file is also the program of its ranks and of its
JAX side).

Three meshes, each spawned once: (data 1, model 2), (data 2, model 2)
and (data 1, model 3).  M = 3 pads: the smoke configs' heads (qwen2-7b's
7 to 9), vocabulary (128 to 129) and experts (8 to 9), and splits the
dense FFN's 128 hidden units unevenly (43, 43, 42).  Every rank loops
over the ten smoke configs at ``cfg.with_tp(M)`` in f32: the JAX-layout
parameters of a seeded model sliced to its blocks
(``convert.tp_params_from_jax``), a prefill of 6 tokens into a cache of
12 and 3 teacher-forced decode steps, with ``flash_decode`` on and off
(the GQA archs) and ``seq_parallel`` on and off.  The logits are held:

  * to JAX's single-device ``lm.prefill`` / ``lm.decode_step`` at
    ``cfg.with_tp(M)`` within 1e-4 (the families' f32 tolerance), whose
    padded heads, vocabulary and experts are zero slots, so it computes
    the logical model (the JAX package's own sharded lowering fails on
    this jax, ROADMAP queue 3);
  * to the port's unsharded path at the same config within 1e-5;
  * with ``seq_parallel`` on against off within 1e-6.

Also: one bf16 case each for llama3.2-1b and granite-moe on (1, 2)
against the unsharded bf16 path within 5 bf16 ulps at the logit scale
(``test_torch_families_bf16.py``'s rule); the collectives a layer
(``compat.CALLS``); that the flash decode's combine keeps each rank's
heads apart; that the blocks from the JAX layout equal those of
``convert.tp_shard_model``; that the train step takes a step on a
``model`` axis of 2; and the refusal of the Mamba archs at M = 3,
whose 128 d_inner channels do not split evenly over 3 (nor the cache's
8 heads), as JAX's ``device_put`` refuses them.
"""

import json
import os
import sys

import numpy as np
import pytest

from _ranks import finish, gloo_rank, spawn

MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x3": (1, 3)}
ARCHS = ("llama3.2-1b", "gemma2-9b", "qwen2-7b", "qwen2-vl-7b",
         "musicgen-medium", "granite-moe-3b-a800m", "moonshot-v1-16b-a3b",
         "minicpm3-4b", "mamba2-780m", "hymba-1.5b")
BATCH, PROMPT, SEQ, GEN = 2, 6, 12, 3
JAX_TOL = 1e-4
PORT_TOL = 1e-5
SP_TOL = 1e-6
BF16_ULPS = 5
BF16 = (("1x2", "llama3.2-1b"), ("1x2", "granite-moe-3b-a800m"))
TIMEOUT_S = 300


def port_config(arch, m):
    from repro_torch.configs import get_smoke_config
    return get_smoke_config(arch).with_tp(m)


def gqa(arch) -> bool:
    cfg = port_config(arch, 1)
    return cfg.mixer in ("attn", "hybrid") and cfg.mla is None


def mamba_refused(arch, m) -> bool:
    cfg = port_config(arch, 1)
    return cfg.mamba is not None and cfg.mamba.n_heads(cfg.d_model) % m != 0


def variants(arch):
    """(flash_decode, seq_parallel) of each path an arch runs."""
    fds = (False, True) if gqa(arch) else (False,)
    return [(fd, sp) for fd in fds for sp in (False, True)]


def vkey(arch, fd, sp):
    return f"{arch}-fd{int(fd)}-sp{int(sp)}"


def inputs(cfg, arch):
    """The prefill batch and the decode feed of an arch (NumPy, f32 or
    int32), the same on every rank and in JAX."""
    rng = np.random.default_rng(sum(map(ord, arch)))
    d = cfg.d_model
    if cfg.frontend == "audio_stub":
        batch = {"embeds": rng.standard_normal((BATCH, PROMPT, d))
                 .astype(np.float32)}
        feed = [{"embeds": rng.standard_normal((BATCH, 1, d))
                 .astype(np.float32)} for _ in range(GEN)]
        return batch, feed
    batch = {"tokens": rng.integers(0, cfg.vocab, (BATCH, PROMPT))
             .astype(np.int32)}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = rng.standard_normal((BATCH, 3, d)).astype(
            np.float32) * 0.1
    feed = [{"tokens": rng.integers(0, cfg.vocab, (BATCH,)).astype(np.int32)}
            for _ in range(GEN)]
    return batch, feed


def _serve(torch, steps, cfg, scfg, model, batch, feed, mesh):
    """Logits (1 + GEN, B, V) of a prefill and the decodes, and the
    collectives (``compat.CALLS`` deltas) of the prefill and of the
    first decode."""
    from repro_torch import compat
    pre = steps.make_prefill_step(cfg, scfg, seq_len=PROMPT, batch=BATCH,
                                  device="cpu", mesh=mesh)
    dec = steps.make_decode_step(cfg, scfg, seq_len=SEQ, batch=BATCH,
                                 device="cpu", mesh=mesh)
    cache = steps.make_cache(cfg, scfg, batch=BATCH, max_len=SEQ,
                             device="cpu", mesh=mesh)
    dt = getattr(torch, scfg.param_dtype)
    b = {k: torch.from_numpy(v).to(dt) if v.dtype == np.float32
         else torch.from_numpy(v) for k, v in batch.items()}
    counts = []
    before = dict(compat.CALLS)
    FLASH[0] = 0
    lg, cache = pre(model, b, cache)
    counts.append({k: compat.CALLS[k] - before[k] for k in before})
    counts[0]["flash"] = FLASH[0]
    out = [lg]
    for t, f in enumerate(feed):
        tok = torch.from_numpy(f["tokens"]) if "tokens" in f else None
        emb = torch.from_numpy(f["embeds"]).to(dt) if "embeds" in f \
            else None
        before = dict(compat.CALLS)
        lg, cache = dec(model, cache, tok, PROMPT + t, embeds=emb)
        if t == 0:
            counts.append({k: compat.CALLS[k] - before[k] for k in before})
        out.append(lg)
    return torch.stack(out).float().numpy(), counts


# Calls of the flash-attention wrapper (its plain version on the CPU),
# counted by the rank program around ``ops.flash_attention``.
FLASH = [0]


def _count_flash():
    from repro_torch.models import attention
    wrapped = attention.ops.flash_attention

    def counted(*a, **kw):
        FLASH[0] += 1
        return wrapped(*a, **kw)
    attention.ops.flash_attention = counted


def _head_check(torch, tp):
    """Each rank's heads after the flash decode's combine: q's heads
    gathered over ``model`` in rank order, attended over this rank's
    cache slice and combined, against one softmax over the whole cache
    for this rank's heads (every rank's q heads differ)."""
    from repro_torch.core.flash_decode import flash_decode_ref, \
        flash_decode_shard
    from repro_torch.models.tp import gather_heads
    m, r = tp.size, tp.rank
    g = torch.Generator().manual_seed(11)
    h, kv, d, s = 2 * m, 2, 8, 4 * m
    q = torch.randn((BATCH, h, d), generator=g)
    k = torch.randn((BATCH, s, kv, d), generator=g)
    v = torch.randn((BATCH, s, kv, d), generator=g)
    mine = slice(r * 2, r * 2 + 2)
    gathered = gather_heads(q[:, mine].contiguous(), tp)
    sl = slice(r * 4, r * 4 + 4)
    out = flash_decode_shard(gathered, k[:, sl], v[:, sl], group=tp.group,
                             pos=s - 2, scale=d ** -0.5)
    want = flash_decode_ref(q, k, v, pos=s - 2, scale=d ** -0.5)
    return {"gathered_exact": bool(torch.equal(gathered, q)),
            "err": float((out[:, mine] - want[:, mine]).abs().max()),
            "other_heads_differ": float((want[:, mine] - want[:, (
                slice(((r + 1) % m) * 2, ((r + 1) % m) * 2 + 2))]).abs()
                .max())}


def rank_main(name: str, rank: int, n: int, store_path: str,
              out_dir: str) -> None:
    import torch
    from repro_torch import serve
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import convert
    from repro_torch.models import tp as tpc
    torch.set_num_threads(1)
    _count_flash()
    dist = gloo_rank(rank, n, store_path)
    shape = MESHES[name]
    m = shape[1]
    report, logits = {}, {}
    try:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        tp = tpc.from_mesh(mesh)
        report["heads"] = _head_check(torch, tp)
        for arch in ARCHS:
            cfg = port_config(arch, m)
            f32 = steps.StepConfig(param_dtype="float32",
                                   cache_dtype="float32")
            if mamba_refused(arch, m):
                try:
                    steps.make_prefill_step(cfg, f32, seq_len=PROMPT,
                                            batch=BATCH, device="cpu",
                                            mesh=mesh)
                    report[f"{arch}-refused"] = "no error"
                except NotImplementedError as e:
                    report[f"{arch}-refused"] = str(e)
                continue
            full = serve.build_model(cfg, 0, "cpu")
            tree = convert.named_to_jax(dict(full.named_parameters()))
            local = convert.tp_params_from_jax(tree, cfg, mesh, "cpu")
            sharded = convert.tp_shard_model(full, cfg, mesh)
            mp = dict(sharded.named_parameters())
            report[f"{arch}-blocks"] = all(
                torch.equal(p, mp[k]) for k, p in local.named_parameters())
            batch, feed = inputs(cfg, arch)
            logits[f"{arch}-unsharded"], _ = _serve(
                torch, steps, cfg, f32, full, batch, feed, None)
            for fd, sp in variants(arch):
                scfg = steps.StepConfig(param_dtype="float32",
                                        cache_dtype="float32",
                                        flash_decode=fd, seq_parallel=sp)
                key = vkey(arch, fd, sp)
                logits[key], report[f"{key}-calls"] = _serve(
                    torch, steps, cfg, scfg, local, batch, feed, mesh)
            if (name, arch) in BF16:
                bf = steps.StepConfig()
                b_full = serve.build_model(cfg, 0, "cpu", torch.bfloat16)
                b_local = convert.tp_shard_model(b_full, cfg, mesh)
                logits[f"{arch}-bf16-unsharded"], _ = _serve(
                    torch, steps, cfg, bf, b_full, batch, feed, None)
                logits[f"{arch}-bf16"], _ = _serve(
                    torch, steps, cfg, bf, b_local, batch, feed, mesh)
        cfg = port_config("llama3.2-1b", m)
        f32 = steps.StepConfig(param_dtype="float32")
        step = steps.make_train_step(cfg, f32, seq_len=PROMPT,
                                     batch=BATCH * shape[0], device="cpu",
                                     mesh=mesh)
        state = steps.build_state(cfg, 0, "cpu", mesh=mesh)
        tok = torch.from_numpy(inputs(cfg, "llama3.2-1b")[0]["tokens"])
        state, loss = step(state, {"tokens": tok, "labels": tok.roll(-1, 1)})
        report["train"] = [float(loss), int(state["opt"]["step"])]
    finally:
        with open(os.path.join(out_dir, f"{name}-rank{rank}.json"),
                  "w") as fh:
            json.dump(report, fh)
        if logits:
            np.savez(os.path.join(out_dir, f"{name}-logits{rank}.npz"),
                     **logits)
        dist.destroy_process_group()


def jax_main(m: int, out_dir: str) -> None:
    """JAX's single-device logits at ``with_tp(m)`` of every arch that
    serves at that M, from the same seeded parameters."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import lm as jlm
    from repro_torch import serve
    from repro_torch.models import convert
    out = {}
    for arch in ARCHS:
        if mamba_refused(arch, m):
            continue
        jc = jconfigs.get_smoke_config(arch).with_tp(m).replace(
            param_dtype="float32")
        cfg = port_config(arch, m)
        params = jax.tree.map(jnp.asarray, convert.named_to_jax(
            dict(serve.build_model(cfg, 0, "cpu").named_parameters())))
        batch, feed = inputs(cfg, arch)
        pre = jax.jit(lambda p, b, c: jlm.prefill(jc, p, b, cache=c))
        dec = jax.jit(lambda p, c, t, pos, e: jlm.decode_step(
            jc, p, c, t, pos, embeds=e))
        cache = jlm.init_cache(jc, BATCH, SEQ, jnp.float32)
        lg, cache = pre(params, {k: jnp.asarray(v) for k, v in
                                 batch.items()}, cache)
        got = [np.asarray(lg)]
        for t, f in enumerate(feed):
            tok = jnp.asarray(f.get("tokens", np.zeros(BATCH, np.int32)))
            emb = jnp.asarray(f["embeds"]) if "embeds" in f else None
            lg, cache = dec(params, cache, tok, jnp.int32(PROMPT + t), emb)
            got.append(np.asarray(lg))
        out[arch] = np.stack(got)
    np.savez(os.path.join(out_dir, f"jax-{m}.npz"), **out)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_serve")
    procs = []
    for name, (dp, m) in MESHES.items():
        n = dp * m
        procs += [spawn(__file__, "rank", name, r, n, out / f"{name}-store",
                        out) for r in range(n)]
    procs += [spawn(__file__, "jax", m, out)
              for m in sorted({m for _, m in MESHES.values()})]
    finish(procs, TIMEOUT_S)
    reports = {name: [json.loads((out / f"{name}-rank{r}.json").read_text())
                      for r in range(dp * m)]
               for name, (dp, m) in MESHES.items()}
    logits = {name: [dict(np.load(out / f"{name}-logits{r}.npz"))
                     for r in range(dp * m)]
              for name, (dp, m) in MESHES.items()}
    jax_out = {m: dict(np.load(out / f"jax-{m}.npz"))
               for m in sorted({m for _, m in MESHES.values()})}
    return reports, logits, jax_out


CASES = [(name, arch, fd, sp) for name, (_, m) in MESHES.items()
         for arch in ARCHS if not mamba_refused(arch, m)
         for fd, sp in variants(arch)]


def _id(case):
    name, arch, fd, sp = case
    return f"{name}-{vkey(arch, fd, sp)}"


@pytest.mark.parametrize("case", CASES, ids=map(_id, CASES))
def test_logits_meet_jax_single_device(results, case):
    name, arch, fd, sp = case
    _, logits, jax_out = results
    want = jax_out[MESHES[name][1]][arch]
    for r, got in enumerate(logits[name]):
        g = got[vkey(arch, fd, sp)]
        assert g.shape == want.shape
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(g), fin)
        np.testing.assert_allclose(g[fin], want[fin], rtol=JAX_TOL,
                                   atol=JAX_TOL, err_msg=f"rank {r}")


@pytest.mark.parametrize("case", CASES, ids=map(_id, CASES))
def test_logits_meet_the_unsharded_port(results, case):
    name, arch, fd, sp = case
    _, logits, _ = results
    for r, got in enumerate(logits[name]):
        g, want = got[vkey(arch, fd, sp)], got[f"{arch}-unsharded"]
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(g), fin)
        np.testing.assert_allclose(g[fin], want[fin], rtol=PORT_TOL,
                                   atol=PORT_TOL, err_msg=f"rank {r}")
        np.testing.assert_array_equal(g, logits[name][0][
            vkey(arch, fd, sp)])


SP_CASES = [(name, arch, fd) for name, arch, fd, sp in CASES if sp]


@pytest.mark.parametrize("case", SP_CASES,
                         ids=[f"{n}-{a}-fd{int(f)}" for n, a, f in SP_CASES])
def test_seq_parallel_agrees_with_the_whole_stream(results, case):
    name, arch, fd = case
    _, logits, _ = results
    for got in logits[name]:
        on, off = got[vkey(arch, fd, True)], got[vkey(arch, fd, False)]
        fin = np.isfinite(off)
        np.testing.assert_allclose(on[fin], off[fin], rtol=SP_TOL,
                                   atol=SP_TOL)


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(abs(x), 1e-30))) - 7)


@pytest.mark.parametrize("case", BF16, ids=[f"{n}-{a}" for n, a in BF16])
def test_bf16_logits_within_five_ulps(results, case):
    name, arch = case
    _, logits, _ = results
    for got in logits[name]:
        g, want = got[f"{arch}-bf16"], got[f"{arch}-bf16-unsharded"]
        fin = np.isfinite(want)
        ulp = _bf16_ulp(float(np.abs(want[fin]).max()))
        assert np.abs(g[fin] - want[fin]).max() <= BF16_ULPS * ulp


@pytest.mark.parametrize("name", MESHES)
def test_blocks_from_the_jax_layout_equal_the_sharded_model(results, name):
    reports, _, _ = results
    m = MESHES[name][1]
    for rep in reports[name]:
        for arch in ARCHS:
            if not mamba_refused(arch, m):
                assert rep[f"{arch}-blocks"], arch


@pytest.mark.parametrize("name", MESHES)
def test_flash_decode_combine_keeps_each_ranks_heads(results, name):
    reports, _, _ = results
    for rep in reports[name]:
        h = rep["heads"]
        assert h["gathered_exact"]
        assert h["err"] <= 1e-5
        assert h["other_heads_differ"] > 0.1


def _calls(rep, arch, fd, sp):
    pre, dec = rep[f"{vkey(arch, fd, sp)}-calls"]
    return ({k: pre[k] for k in ("all_reduce", "all_gather",
                                 "reduce_scatter")},
            {k: dec[k] for k in ("all_reduce", "all_gather",
                                 "reduce_scatter")})


@pytest.mark.parametrize("name", MESHES)
def test_collectives_a_layer(results, name):
    """Dense GQA (llama3.2-1b, 2 layers): without SP a prefill makes 2
    all-reduces a layer and one for the embedding, and all-gathers the
    logits; with SP 2 all-gathers and 2 reduce-scatters a layer, the
    embedding reduce-scattered and the last positions and the logits
    all-gathered.  A decode step without flash decode adds the K and V
    gathers of a sequence-split cache (2 a layer), with it the flash
    decode's 3 all-reduces and q's head gather a layer.  The hybrid
    (hymba-1.5b, 3 layers) sends its two branches' partial outputs in
    one all-reduce, beside the gated norm's and the FFN's."""
    reports, _, _ = results
    L = 2
    for rep in reports[name]:
        pre, dec = _calls(rep, "llama3.2-1b", False, False)
        assert pre == {"all_reduce": 2 * L + 1, "all_gather": 1,
                       "reduce_scatter": 0}
        assert dec == {"all_reduce": 2 * L + 1, "all_gather": 2 * L + 1,
                       "reduce_scatter": 0}
        pre, _ = _calls(rep, "llama3.2-1b", False, True)
        assert pre == {"all_reduce": 0, "all_gather": 2 * L + 2,
                       "reduce_scatter": 2 * L + 1}
        _, dec = _calls(rep, "llama3.2-1b", True, True)
        assert dec == {"all_reduce": 3 * L + 2 * L + 1,
                       "all_gather": L + 1, "reduce_scatter": 0}
        if "hymba-1.5b-fd0-sp0-calls" in rep:
            pre, _ = _calls(rep, "hymba-1.5b", False, False)
            assert pre == {"all_reduce": 3 * 3 + 1, "all_gather": 1,
                           "reduce_scatter": 0}
            pre, _ = _calls(rep, "hymba-1.5b", False, True)
            assert pre == {"all_reduce": 3, "all_gather": 2 * 3 + 2,
                           "reduce_scatter": 2 * 3 + 1}


def _uniform_layers(arch, m, rank) -> int:
    """Attention layers whose q heads on model rank ``rank`` use their
    KV heads uniformly (``attention.kv_window``)."""
    from repro_torch.models.attention import kv_window
    cfg = port_config(arch, m)
    h = cfg.n_heads_padded // m
    return cfg.n_layers if kv_window(cfg.head_map[rank * h:(rank + 1) * h]) \
        else 0


FLASH_CASES = [(name, arch) for name, (_, m) in MESHES.items()
               for arch in ARCHS if gqa(arch) and not mamba_refused(arch, m)]


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"{n}-{a}" for n, a in FLASH_CASES])
def test_prefill_takes_flash_where_the_local_map_is_uniform(results, case):
    """Every GQA prefill under TP reaches the flash wrapper once a layer
    where the rank's run of the head map is uniform -- on every rank
    here, also where the padded map as a whole is not (llama3.2-1b's at
    M = 3)."""
    name, arch = case
    reports, _, _ = results
    dp, m = MESHES[name]
    for i, rep in enumerate(reports[name]):
        want = _uniform_layers(arch, m, i % m)
        assert want == port_config(arch, m).n_layers
        for fd, sp in variants(arch):
            assert rep[f"{vkey(arch, fd, sp)}-calls"][0]["flash"] == want


def test_train_step_refuses_a_model_axis(results):
    """The train step builds and takes a step on a ``model`` axis of 2
    (it refused one before the tensor-parallel training step: the name
    stays; ``tests/test_torch_tp_train.py`` holds what it computes):
    every rank of a mesh gets the same finite loss."""
    reports, _, _ = results
    for name in ("1x2", "2x2"):
        losses = {tuple(rep["train"]) for rep in reports[name]}
        assert len(losses) == 1, losses
        loss, at = losses.pop()
        assert np.isfinite(loss) and at == 1


@pytest.mark.parametrize("arch", [a for a in ARCHS if mamba_refused(a, 3)])
def test_mamba_heads_that_do_not_split_are_refused(results, arch):
    reports, _, _ = results
    for rep in reports["1x3"]:
        assert "do not split evenly over 3 model ranks" in \
            rep[f"{arch}-refused"]


def test_step_config_has_the_references_fields():
    """``StepConfig`` holds the JAX package's fields with its defaults
    (``seq_parallel``, ``moe_chunk``, ``capacity_factor`` among them),
    and ``_apply_overrides`` gives the MoE config JAX's gives."""
    import dataclasses

    from repro import configs as jconfigs
    from repro.launch import steps as jsteps
    from repro_torch.launch import steps
    jf = {f.name: f.default for f in dataclasses.fields(jsteps.StepConfig)
          if f.default is not dataclasses.MISSING}
    pf = {f.name: f.default for f in dataclasses.fields(steps.StepConfig)
          if f.default is not dataclasses.MISSING}
    assert pf == jf
    for kw in ({}, {"moe_chunk": 64}, {"capacity_factor": 2.0},
               {"moe_chunk": 32, "capacity_factor": 8.0}):
        for arch in ("granite-moe-3b-a800m", "llama3.2-1b"):
            got = steps._apply_overrides(port_config(arch, 2),
                                         steps.StepConfig(**kw))
            want = jsteps._apply_overrides(
                jconfigs.get_smoke_config(arch).with_tp(2),
                jsteps.StepConfig(**kw))
            assert (got.moe is None) == (want.moe is None)
            if got.moe is not None:
                assert dataclasses.asdict(got.moe) == \
                    dataclasses.asdict(want.moe)


if __name__ == "__main__":
    if sys.argv[1] == "rank":
        rank_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5], sys.argv[6])
    else:
        jax_main(int(sys.argv[2]), sys.argv[3])
