"""Mamba-2 under tensor parallelism wherever the JAX package places it,
on ``gloo`` ranks in subprocesses (this file is also the program of its
ranks, of its JAX side and of its fake-group side).

JAX's ``device_put`` places a leaf only where the mesh axis divides
every dim it splits.  The Mamba parameters split d_inner over ``model``
(``lm.param_specs``), so they place wherever M divides d_inner, in equal
blocks that may start or end inside a head; the serving cache splits
the heads (``state``) and d_inner (``conv_x``), so it places only where
M divides the heads.  The port trains and serves exactly there.

Variants of the smoke configs, made with ``replace`` in both packages:
``mamba2-d40`` and ``hymba-d40`` (d_model 40: 80 channels, 5 heads of 16,
so M = 2 cuts at 2.5 heads a rank) and ``mamba2-d48-g2`` (d_model 48,
``n_groups=2``: 6 heads, 3 a group; at M = 3 rank 1 holds heads 2-3,
which straddle both groups, at M = 4 each rank holds 1.5 heads).  Meshes,
each spawned once:

  * (2, 2): the d_model-40 pair trained ``STEPS`` steps with ZeRO-1 over
    the data axis; their serving steps are refused;
  * (1, 3): the group variant served (f32 prefill and decodes) and
    trained;
  * (1, 4): the group variant trained (a cut and groups together).

Held: the step-0 synced gradients reassembled from the ranks' blocks
(``convert.tp_named_to_jax``) against JAX's ``value_and_grad(lm.loss_fn)``
at ``cfg.with_tp(M)`` on one device, averaged over the data shards,
within ``GRAD_TOL``; each rank's blocks against the port's unsharded step
within ``PORT_TOL``; the losses against JAX's 3-step chain and the
unsharded step's within ``LOSS_RTOL``; the logits against JAX's
``lm.prefill`` / ``lm.decode_step`` within ``JAX_TOL`` and the unsharded
port's within ``PORT_TOL``; a cut state saved on its mesh restores whole
(no mesh) equal to the gathered state and, through ``reshard``, onto the
same mesh bit for bit.

The rule: for mamba2 and hymba at d_model 64, 40 and 48 and M in 2, 3,
4 and 16, the port's steps (made on rank 0 of a fake 16-rank group)
refuse exactly where JAX's ``device_put`` on 16 host devices refuses the
Mamba leaves: the parameters for training, the parameters or the cache
for serving; and where they accept, rank 0's blocks of the Mamba leaves
are JAX's first shard.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest

from _ranks import finish, gloo_rank, spawn

VARIANTS = {"mamba2-d40": ("mamba2-780m", 40, 1),
            "hymba-d40": ("hymba-1.5b", 40, 1),
            "mamba2-d48-g2": ("mamba2-780m", 48, 2)}
# mesh -> (shape, the variants it trains, whether they serve there)
MESHES = {"2x2": ((2, 2), ("mamba2-d40", "hymba-d40"), False),
          "1x3": ((1, 3), ("mamba2-d48-g2",), True),
          "1x4": ((1, 4), ("mamba2-d48-g2",), False)}
ROWS, S, STEPS, AGGR = 2, 24, 3, 1 << 12
BATCH, PROMPT, SEQ, GEN = 2, 6, 12, 3
PEAK_LR = 1e-3
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)   # test_torch_tp_train.py
PORT_TOL = 1e-5
LOSS_RTOL = 1e-5
JAX_TOL = 1e-4
# the rule test's configs: (arch, d_model) x M
RULE_ARCHS = ("mamba2-780m", "hymba-1.5b")
RULE_WIDTHS = (64, 40, 48)
RULE_MS = (2, 3, 4, 16)
RULE_DEVICES = 16
# what JAX places at each (d_model, M): (parameters, cache)
PLACED = {(64, 2): (True, True), (64, 3): (False, False),
          (64, 4): (True, True), (64, 16): (True, False),
          (40, 2): (True, False), (40, 3): (False, False),
          (40, 4): (True, False), (40, 16): (True, False),
          (48, 2): (True, True), (48, 3): (True, True),
          (48, 4): (True, False), (48, 16): (True, False)}
TIMEOUT_S = 240


def _vary(cfg, d_model: int, n_groups: int):
    return cfg.replace(d_model=d_model, mamba=dataclasses.replace(
        cfg.mamba, n_groups=n_groups))


def port_config(variant):
    from repro_torch.configs import get_smoke_config
    arch, d, g = VARIANTS[variant]
    return _vary(get_smoke_config(arch), d, g).replace(param_dtype="float32")


def jax_config(variant, m):
    from repro import configs as jconfigs
    arch, d, g = VARIANTS[variant]
    return _vary(jconfigs.get_smoke_config(arch), d, g).with_tp(m).replace(
        param_dtype="float32")


def step_config():
    from repro_torch.launch.steps import StepConfig
    return StepConfig(sync_mode="partitioned", aggr_bytes=AGGR,
                      param_dtype="float32", peak_lr=PEAK_LR,
                      warmup_steps=1, total_steps=10)


def serve_config():
    from repro_torch.launch.steps import StepConfig
    return StepConfig(param_dtype="float32", cache_dtype="float32")


def shard_batches(cfg, index: int, count: int):
    """Data shard ``index`` of ``count`` (``ROWS`` rows each) of the
    first ``STEPS`` global batches, NumPy."""
    from repro_torch.data import pipeline
    stream = pipeline.for_model(cfg, S, ROWS * count, host_index=index,
                                host_count=count)
    return [stream.batch(i) for i in range(STEPS)]


def serve_inputs(cfg):
    """The prefill tokens and the decode feed, NumPy int32."""
    rng = np.random.default_rng(7)
    return (rng.integers(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32),
            [rng.integers(0, cfg.vocab, (BATCH,)).astype(np.int32)
             for _ in range(GEN)])


def _serve(torch, steps, cfg, model, mesh):
    """Logits (1 + GEN, B, V) of a prefill and ``GEN`` decodes."""
    scfg = serve_config()
    pre = steps.make_prefill_step(cfg, scfg, seq_len=PROMPT, batch=BATCH,
                                  device="cpu", mesh=mesh)
    dec = steps.make_decode_step(cfg, scfg, seq_len=SEQ, batch=BATCH,
                                 device="cpu", mesh=mesh)
    cache = steps.make_cache(cfg, scfg, batch=BATCH, max_len=SEQ,
                             device="cpu", mesh=mesh)
    prompt, feed = serve_inputs(cfg)
    lg, cache = pre(model, torch.from_numpy(prompt), cache)
    out = [lg]
    for t, tok in enumerate(feed):
        lg, cache = dec(model, cache, torch.from_numpy(tok), PROMPT + t)
        out.append(lg)
    return torch.stack(out).float().numpy()


def _excess(got, want, tol) -> float:
    """The largest |got - want| beyond ``tol`` (absolute and relative);
    <= 0 when within."""
    return float(((got - want).abs() - tol - tol * want.abs()).max())


def _keep(trees, key, tree):
    from repro_torch.models import convert
    for leaf, a in convert.jax_to_leaves(tree).items():
        trees[f"{key}/{leaf}"] = a


def _refusals(steps, cfg, mesh) -> dict:
    """Each step's refusal on ``mesh`` (its message, or "no error")."""
    out = {}
    for name, make in (("train", steps.make_train_step),
                       ("prefill", steps.make_prefill_step),
                       ("decode", steps.make_decode_step)):
        try:
            make(cfg, step_config(), seq_len=S, batch=BATCH, device="cpu",
                 mesh=mesh)
            out[name] = "no error"
        except NotImplementedError as e:
            out[name] = str(e)
    try:
        steps.make_cache(cfg, serve_config(), batch=BATCH, max_len=SEQ,
                         device="cpu", mesh=mesh)
        out["cache"] = "no error"
    except ValueError as e:
        out["cache"] = str(e)
    return out


def _checkpoint(torch, dist, cfg, mesh, state, path, rank) -> dict:
    """Save the cut ``state`` (rank 0 writes the gathered leaves), then
    restore it whole (no mesh) and onto the same mesh: whether each
    equals what was saved bit for bit."""
    from repro_torch.ckpt import checkpoint as pckpt
    from repro_torch.launch import steps
    from repro_torch.models import convert
    tree = convert.state_to_jax(state)
    if rank == 0:
        pckpt.save(path, STEPS, tree)
    dist.barrier()
    saved = convert.jax_to_leaves(tree)
    at, whole = pckpt.restore(path, tree)
    plain = convert.state_from_jax(whole, cfg.with_tp(
        mesh.shape[1]), device="cpu")
    again = convert.jax_to_leaves(convert.state_to_jax(plain))
    same_whole = at == STEPS and set(again) == set(saved) and all(
        np.array_equal(again[k], saved[k]) for k in saved)
    at, placed = pckpt.restore(path, tree, shardings={
        "params": steps.param_shardings(cfg, mesh),
        "opt": steps.opt_shardings(cfg, mesh)})
    back = convert.state_from_jax(placed, cfg, device="cpu", mesh=mesh)
    mine = dict(state["params"].named_parameters())
    same_mesh = at == STEPS and int(back["opt"]["step"]) == STEPS and all(
        torch.equal(p, mine[k]) for k, p in back["params"]
        .named_parameters()) and all(
        torch.equal(t.to_local(), state["opt"][key][k].to_local())
        for key in ("m", "v") for k, t in back["opt"][key].items())
    return {"whole": bool(same_whole), "mesh": bool(same_mesh)}


def rank_main(name: str, rank: int, n: int, store_path: str,
              out_dir: str) -> None:
    import torch
    from repro_torch import serve
    from repro_torch.launch import mesh as pmesh
    from repro_torch.launch import steps
    from repro_torch.models import convert, lm
    torch.set_num_threads(1)
    dist = gloo_rank(rank, n, store_path)
    (dp, m), variants, serves = MESHES[name]
    report, trees = {}, {}
    try:
        mesh = pmesh.make_mesh((dp, m), ("data", "model"), "cpu")
        di = pmesh.axis_index(mesh, pmesh.dp_axes(mesh))
        dp_group = pmesh.axis_group(mesh, pmesh.dp_axes(mesh))
        for v in variants:
            cfg = port_config(v)
            cfg_tp = cfg.with_tp(m)
            rep = report[v] = {}
            data = [steps.batch_to_device(b, "cpu")
                    for b in shard_batches(cfg, di, dp)]
            # the unsharded step on the same rows, synced over the data
            # axes, from the same seed
            plain = steps.build_state(cfg_tp, 0, "cpu")
            ustep = steps.make_train_step(cfg_tp, step_config(), seq_len=S,
                                          batch=ROWS, device="cpu",
                                          group=dp_group)
            rep["plain_losses"] = []
            for i, b in enumerate(data):
                plain, loss = ustep(plain, b)
                rep["plain_losses"].append(float(loss))
                if i == 0:
                    want = {k: p.grad.clone() for k, p in
                            plain["params"].named_parameters()}
            del plain
            state = steps.build_state(cfg, 0, "cpu", mesh=mesh)
            step = steps.make_train_step(cfg, step_config(), seq_len=S,
                                         batch=ROWS * dp, device="cpu",
                                         mesh=mesh)
            blocks = lm.param_blocks(cfg_tp, mesh)
            rep["losses"] = []
            for i, b in enumerate(data):
                state, loss = step(state, b)
                rep["losses"].append(float(loss))
                if i:
                    continue
                grads = {k: p.grad for k, p in
                         state["params"].named_parameters()}
                excess = float("-inf")
                for k, g in grads.items():
                    parts = k.split(".")
                    sl = blocks[".".join(["layers", *parts[2:]])][1:] \
                        if parts[0] == "layers" else blocks[k]
                    excess = max(excess, _excess(g, want[k][sl], PORT_TOL))
                rep["block_excess"] = excess
                gtree = convert.tp_named_to_jax(grads, cfg_tp, mesh)
                if rank == 0:
                    _keep(trees, f"{v}-grads", gtree)
            rep["channels"] = [blocks["layers.mamba.w_x"][2].start,
                               blocks["layers.mamba.w_x"][2].stop]
            specs = steps.opt_specs(cfg_tp, mesh)["m"]
            shapes = lm.param_shapes(cfg_tp)
            rep["zero1"] = {
                leaf: [list(t.to_local().shape), [
                    s.stop - s.start for s in pmesh.local_slices(
                        shapes[leaf], specs[leaf], mesh, uneven=True)],
                    sorted({a for e in specs[leaf]
                            for a in pmesh.spec_axes(e)})]
                for leaf, t in state["opt"]["m"].items()}
            rep["ckpt"] = _checkpoint(torch, dist, cfg, mesh, state,
                                      os.path.join(out_dir,
                                                   f"ckpt-{name}-{v}"), rank)
            rep["refused"] = _refusals(steps, cfg, mesh)
            full = serve.build_model(cfg_tp, 0, "cpu")
            local = convert.tp_shard_model(full, cfg_tp, mesh)
            tree = convert.named_to_jax(dict(full.named_parameters()))
            from_jax = convert.tp_params_from_jax(tree, cfg_tp, mesh, "cpu")
            mp = dict(local.named_parameters())
            rep["blocks_from_jax"] = all(
                torch.equal(p, mp[k]) for k, p in from_jax.named_parameters())
            if serves:
                rep["logits_unsharded"] = _serve(torch, steps, cfg_tp, full,
                                                 None).tolist()
                rep["logits"] = _serve(torch, steps, cfg_tp, local,
                                       mesh).tolist()
    finally:
        with open(os.path.join(out_dir, f"{name}-rank{rank}.json"),
                  "w") as fh:
            json.dump(report, fh)
        if trees:
            np.savez(os.path.join(out_dir, f"{name}-trees.npz"), **trees)
        dist.destroy_process_group()


def jax_main(m: int, out_dir: str) -> None:
    """JAX at ``with_tp(m)`` from the port's seeded model, per variant
    trained on a mesh with this M: the step-0 gradients (the mean of
    the data shards' ``value_and_grad``) and the 3-step chain's losses
    through ``adamw_update`` and ``warmup_cosine``; per variant served,
    the prefill and decode logits."""
    import jax
    import jax.numpy as jnp

    from repro.models import lm as jlm
    from repro.optim import adamw as jadamw
    from repro.optim.schedule import warmup_cosine
    from repro_torch import serve
    from repro_torch.launch import steps
    from repro_torch.models import convert
    out = {}
    scfg = step_config()
    for name, ((dp, mm), variants, serves) in MESHES.items():
        if mm != m:
            continue
        for v in variants:
            cfg, jc = port_config(v), jax_config(v, m)
            model = steps.build_state(cfg.with_tp(m), 0, "cpu")["params"]
            params = jax.tree.map(jnp.asarray, convert.named_to_jax(
                dict(model.named_parameters())))
            vg = jax.jit(jax.value_and_grad(
                lambda p, b: jlm.loss_fn(jc, p, b)))

            @jax.jit
            def update(params, grads, opt):
                grads = jax.tree.map(lambda *gs: sum(gs) / len(gs), *grads)
                lr = warmup_cosine(opt["step"], peak_lr=scfg.peak_lr,
                                   warmup_steps=scfg.warmup_steps,
                                   total_steps=scfg.total_steps)
                return jadamw.adamw_update(params, grads, opt, lr,
                                           jadamw.AdamWConfig())
            shards = [shard_batches(cfg, i, dp) for i in range(dp)]
            opt = jadamw.init_opt_state(params, jadamw.AdamWConfig())
            losses = []
            for t in range(STEPS):
                res = [vg(params, {k: jnp.asarray(x) for k, x in
                                   sh[t].items()}) for sh in shards]
                losses.append(sum(float(r[0]) for r in res) / dp)
                if t == 0:
                    for leaf in convert.jax_to_leaves(res[0][1]):
                        out[f"{v}-grads/{leaf}"] = sum(
                            np.asarray(convert.jax_to_leaves(r[1])[leaf])
                            for r in res) / dp
                params, opt = update(params, [r[1] for r in res], opt)
            out[f"{v}-losses"] = np.asarray(losses)
            if not serves:
                continue
            params = jax.tree.map(jnp.asarray, convert.named_to_jax(
                dict(serve.build_model(cfg.with_tp(m), 0, "cpu")
                     .named_parameters())))
            prompt, feed = serve_inputs(cfg)
            cache = jlm.init_cache(jc, BATCH, SEQ, jnp.float32)
            lg, cache = jax.jit(lambda p, b, c: jlm.prefill(
                jc, p, b, cache=c))(params, {"tokens": jnp.asarray(prompt)},
                                    cache)
            got = [np.asarray(lg)]
            dec = jax.jit(lambda p, c, t, pos: jlm.decode_step(
                jc, p, c, t, pos))
            for t, tok in enumerate(feed):
                lg, cache = dec(params, cache, jnp.asarray(tok),
                                jnp.int32(PROMPT + t))
                got.append(np.asarray(lg))
            out[f"{v}-logits"] = np.stack(got)
    np.savez(os.path.join(out_dir, f"jax-{m}.npz"), **out)


def _rule_config(arch, d_model, package):
    """A rule-test config of ``package`` (``repro`` or ``repro_torch``)."""
    import importlib
    configs = importlib.import_module(f"{package}.configs")
    return _vary(configs.get_smoke_config(arch), d_model, 1)


def _rule_key(arch, d_model, m):
    return f"{arch}-d{d_model}-m{m}"


def place_main(out_dir: str) -> None:
    """JAX's side of the rule: on (1, M) meshes of the first M of 16
    host devices, whether ``device_put`` places each Mamba parameter
    leaf of ``with_tp(M)`` (and the cache's) and, where the parameters
    place, device 0's block of each of them."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    from repro.models import lm as jlm
    out = {}

    def flat(tree):
        return {"/".join(str(getattr(k, "key", k)) for k in path): x
                for path, x in jax.tree_util.tree_flatten_with_path(
                    tree, is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec))[0]}

    def place(shape, spec, mesh):
        try:
            a = jax.device_put(np.zeros(shape, np.float32),
                               NamedSharding(mesh, spec))
        except ValueError:
            return None
        first = next(s for s in a.addressable_shards
                     if s.device == mesh.devices.flat[0])
        return [[sl.start or 0, shape[d] if sl.stop is None else sl.stop]
                for d, sl in enumerate(first.index)]
    for arch in RULE_ARCHS:
        for d_model in RULE_WIDTHS:
            for m in RULE_MS:
                jc = _rule_config(arch, d_model, "repro").with_tp(m)
                mesh = Mesh(np.array(jax.devices()[:m]).reshape(1, m),
                            ("data", "model"))
                shapes = flat(jax.eval_shape(
                    lambda: jlm.init_params(jc, jax.random.PRNGKey(0))))
                specs = flat(jlm.param_specs(jc))
                blocks = {k: place(shapes[k].shape, specs[k], mesh)
                          for k in shapes if k.startswith("layers/mamba/")}
                cshapes = jax.eval_shape(
                    lambda: jlm.init_cache(jc, 1, 1, jnp.float32))
                cspecs = jlm.cache_specs(jc)
                cache = all(place(cshapes[k].shape, cspecs[k], mesh)
                            is not None for k in ("state", "conv_x"))
                params = all(b is not None for b in blocks.values())
                out[_rule_key(arch, d_model, m)] = {
                    "params": params, "cache": cache,
                    "blocks": {k.replace("/", "."): b
                               for k, b in blocks.items()}}
    with open(os.path.join(out_dir, "place-jax.json"), "w") as fh:
        json.dump(out, fh)


def fake_main(out_dir: str) -> None:
    """The port's side of the rule: rank 0 of a fake 16-rank group makes
    each step on a (1, M) mesh; whether each refuses and, where the
    train step is made, rank 0's blocks of the Mamba leaves."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import mesh as pmesh
    from repro_torch.launch import steps
    from repro_torch.models import lm
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=RULE_DEVICES)
    out = {}
    scfg = steps.StepConfig(param_dtype="float32")
    try:
        for m in RULE_MS:
            mesh = pmesh.make_mesh((1, m), ("data", "model"), "cpu")
            for arch in RULE_ARCHS:
                for d_model in RULE_WIDTHS:
                    cfg = _rule_config(arch, d_model, "repro_torch")
                    rec = {}
                    for kind, make in (("train", steps.make_train_step),
                                       ("prefill", steps.make_prefill_step),
                                       ("decode", steps.make_decode_step)):
                        try:
                            make(cfg, scfg, seq_len=48, batch=2,
                                 device="cpu", mesh=mesh)
                            rec[kind] = None
                        except NotImplementedError as e:
                            rec[kind] = str(e)
                    if rec["train"] is None:
                        blocks = lm.param_blocks(cfg.with_tp(m), mesh)
                        rec["blocks"] = {
                            k: [[s.start, s.stop] for s in b]
                            for k, b in blocks.items()
                            if k.startswith("layers.mamba.")}
                    out[_rule_key(arch, d_model, m)] = rec
    finally:
        with open(os.path.join(out_dir, "place-port.json"), "w") as fh:
            json.dump(out, fh)
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_mamba")
    procs = []
    for name, ((dp, m), _, _) in MESHES.items():
        n = dp * m
        procs += [spawn(__file__, "rank", name, r, n, out / f"{name}-store",
                        out) for r in range(n)]
    ms = sorted({shape[1] for shape, _, _ in MESHES.values()})
    procs += [spawn(__file__, "jax", m, out) for m in ms]
    procs += [spawn(__file__, "place", out, devices=RULE_DEVICES),
              spawn(__file__, "fake", out)]
    finish(procs, TIMEOUT_S)
    reports = {name: [json.loads((out / f"{name}-rank{r}.json").read_text())
                      for r in range(shape[0] * shape[1])]
               for name, (shape, _, _) in MESHES.items()}
    trees = {name: dict(np.load(out / f"{name}-trees.npz"))
             for name in MESHES}
    jax_out = {m: dict(np.load(out / f"jax-{m}.npz")) for m in ms}
    place = {side: json.loads((out / f"place-{side}.json").read_text())
             for side in ("jax", "port")}
    return reports, trees, jax_out, place


RUNS = [(name, v) for name, (_, vs, _) in MESHES.items() for v in vs]
RUN_IDS = [f"{n}-{v}" for n, v in RUNS]


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_step0_grads_meet_jax(results, run):
    """The reassembled step-0 gradients within ``GRAD_TOL`` of JAX's
    at ``with_tp(M)``, averaged over the data shards."""
    name, v = run
    _, trees, jax_out, _ = results
    want = jax_out[MESHES[name][0][1]]
    prefix = f"{v}-grads/"
    leaves = [k[len(prefix):] for k in want if k.startswith(prefix)]
    assert any("mamba" in k for k in leaves)
    for leaf in leaves:
        np.testing.assert_allclose(trees[name][prefix + leaf],
                                   want[prefix + leaf], **GRAD_TOL,
                                   err_msg=f"{name} {v}: {leaf}")


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_each_ranks_blocks_meet_the_unsharded_step(results, run):
    name, v = run
    reports, _, _, _ = results
    for r, rep in enumerate(reports[name]):
        assert rep[v]["block_excess"] <= 0.0, (r, rep[v]["block_excess"])


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_losses_meet_jax_and_the_unsharded_step(results, run):
    name, v = run
    reports, _, jax_out, _ = results
    first = reports[name][0][v]["losses"]
    assert len(first) == STEPS and np.all(np.isfinite(first))
    for rep in reports[name]:
        assert rep[v]["losses"] == first
        np.testing.assert_allclose(first, rep[v]["plain_losses"],
                                   rtol=LOSS_RTOL)
    np.testing.assert_allclose(first, jax_out[MESHES[name][0][1]][
        f"{v}-losses"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_channel_blocks_are_jaxs_equal_blocks(results, run):
    """Each rank holds the rank-th of M equal blocks of d_inner; on the
    meshes where M does not divide the heads some block cuts a head."""
    name, v = run
    reports, _, _, _ = results
    (dp, m), _, _ = MESHES[name]
    cfg = port_config(v)
    di, hd = cfg.mamba.d_inner(cfg.d_model), cfg.mamba.head_dim
    got = [rep[v]["channels"] for rep in reports[name]]
    assert got == [[(r % m) * di // m, (r % m + 1) * di // m]
                   for r in range(dp * m)]
    cuts = any(c % hd for pair in got for c in pair)
    assert cuts == bool(cfg.mamba.n_heads(cfg.d_model) % m)


@pytest.mark.parametrize("run", [r for r in RUNS if r[0] == "2x2"],
                         ids=[i for r, i in zip(RUNS, RUN_IDS)
                              if r[0] == "2x2"])
def test_zero1_moments_over_a_cut(results, run):
    """The moments are ZeRO-1 DTensors whose local blocks are the
    parameters' (cut) blocks cut again over the data axis; the Mamba
    d_inner leaves split over both axes."""
    name, v = run
    reports, _, _, _ = results
    for rep in reports[name]:
        z = rep[v]["zero1"]
        for leaf, (local, want, _) in z.items():
            assert local == want, leaf
        both = {leaf for leaf, (_, _, axes) in z.items()
                if axes == ["data", "model"]}
        assert {"layers.mamba.w_x", "layers.mamba.w_z"} <= both


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_blocks_from_jax_are_tp_shard_models(results, run):
    """``convert.tp_params_from_jax`` cuts JAX's tree into the blocks
    ``tp_shard_model`` cuts from the whole port model, bit for bit."""
    name, v = run
    reports, _, _, _ = results
    for rep in reports[name]:
        assert rep[v]["blocks_from_jax"]


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_cut_checkpoint_restores_whole_and_on_its_mesh(results, run):
    name, v = run
    reports, _, _, _ = results
    for rep in reports[name]:
        assert rep[v]["ckpt"] == {"whole": True, "mesh": True}


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_refusals_on_the_mesh(results, run):
    """Training runs; serving is refused where M does not divide the
    heads (the cache's state cannot place), with JAX's reason."""
    name, v = run
    reports, _, _, _ = results
    (_, m), _, serves = MESHES[name]
    for rep in reports[name]:
        got = rep[v]["refused"]
        assert got["train"] == "no error"
        for kind in ("prefill", "decode"):
            if serves:
                assert got[kind] == "no error"
            else:
                assert f"do not split evenly over {m} model ranks" in \
                    got[kind] and "cache state dim 2" in got[kind]
        assert (got["cache"] == "no error") == serves
        if not serves:
            assert f"not divisible by {m}" in got["cache"]


@pytest.mark.parametrize("against", ("jax", "unsharded"))
def test_groups_over_a_block_of_heads_serve(results, against):
    """The group variant's f32 prefill and decode logits on (1, 3)
    against JAX's within ``JAX_TOL`` and the unsharded port's within
    ``PORT_TOL``."""
    reports, _, jax_out, _ = results
    v = "mamba2-d48-g2"
    for rep in reports["1x3"]:
        got = np.asarray(rep[v]["logits"])
        want = jax_out[3][f"{v}-logits"] if against == "jax" else \
            np.asarray(rep[v]["logits_unsharded"])
        assert got.shape[:2] == (1 + GEN, BATCH)
        tol = JAX_TOL if against == "jax" else PORT_TOL
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


RULES = [(arch, d, m) for arch in RULE_ARCHS for d in RULE_WIDTHS
         for m in RULE_MS]


@pytest.mark.parametrize("case", RULES,
                         ids=[_rule_key(*c) for c in RULES])
def test_the_port_refuses_exactly_where_jax_cannot_place(results, case):
    """Train refused iff a Mamba parameter does not place; prefill and
    decode refused iff a Mamba parameter or the cache's state or conv_x
    does not; the reason names the leaves and M.  Where the train step
    is made, rank 0's blocks of the Mamba leaves are device 0's."""
    arch, d_model, m = case
    _, _, _, place = results
    key = _rule_key(*case)
    jx, pt = place["jax"][key], place["port"][key]
    assert (jx["params"], jx["cache"]) == PLACED[(d_model, m)]
    assert (pt["train"] is None) == jx["params"]
    for kind in ("prefill", "decode"):
        assert (pt[kind] is None) == (jx["params"] and jx["cache"])
    for kind in ("train", "prefill", "decode"):
        if pt[kind] is not None:
            assert f"do not split evenly over {m} model ranks" in pt[kind]
            assert "layers.mamba." in pt[kind] or "cache " in pt[kind]
    if pt["train"] is not None:
        assert "ZeRO-1 moments" in pt["train"]
    else:
        assert pt["blocks"] == jx["blocks"]


if __name__ == "__main__":
    if sys.argv[1] == "rank":
        rank_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5], sys.argv[6])
    elif sys.argv[1] == "jax":
        jax_main(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1] == "place":
        place_main(sys.argv[2])
    else:
        fake_main(sys.argv[2])
