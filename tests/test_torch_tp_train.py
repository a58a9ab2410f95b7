"""The tensor-parallel training step on ``gloo`` ranks in subprocesses
(this file is also the program of its ranks and of its JAX side).

Three meshes, each spawned once: (data 1, model 2), (data 2, model 2)
and (data 1, model 3).  Every rank loops over the ten smoke configs in
f32 at ``cfg.with_tp(M)`` (the Mamba archs are refused at M = 3: their
128 d_inner channels do not split evenly over 3, where JAX's
``device_put`` refuses them too), two rows of every data shard, 24 tokens
(qwen2-vl 96, with M-RoPE grid positions over its 64 patches), so the
stream splits along the sequence over 2 and 3 ranks.  The step
(``make_train_step(..., mesh=)``, partitioned sync, sequence parallel)
takes 3 steps from ``build_state(..., mesh=)``; the unsharded step
(``make_train_step`` on the whole model, the sync over the data axes)
takes the same 3 on the same rows from the same seed.  Held:

  * the step-0 synced gradients, reassembled from every rank's blocks
    into the JAX tree (``convert.tp_named_to_jax``), against JAX's
    ``value_and_grad(lm.loss_fn)`` at ``with_tp(M)`` taken on each data
    shard and averaged (what ``make_train_step`` composes under
    ``shard_map``; it cannot be called at ``with_tp(M)`` on one device,
    as it re-pads to the mesh) within ``GRAD_TOL``, and each rank's
    blocks against the unsharded step's within ``PORT_TOL``;
  * the three losses against JAX's chain (those gradients, then
    ``adamw_update`` with ``warmup_cosine``) within ``LOSS_RTOL``, and
    the parameters after 3 steps against the unsharded step's within
    ``PORT_TOL`` -- but the elements whose step-0 gradient in the
    unsharded step is zero to rounding (at most ``ZERO_REL`` of the
    largest of the step, the scale of the terms a gradient sums): f32
    cannot resolve such a sum, the two summation orders leave it with
    different rounding, and Adam's normalisation turns that into steps
    of up to ``lr`` (a few of ``bk``'s, whose terms cancel under RoPE,
    and of the MoE experts').  They are printed with their gradients and
    held to ``NOISE_STEPS`` such steps;
  * all three sync modes (step 0) for llama3.2-1b, granite-moe,
    minicpm3 and hymba, and ``seq_parallel`` off for llama3.2-1b and
    hymba (llama3.2-1b at M = 3);
  * the collectives of step 0 (``compat.CALLS``): the data-axis
    all-reduces are the buckets of JAX's ``make_plan`` over this rank's
    leaves plus the loss's (``step_fn.log``), the model-axis gradient
    sum one all-reduce per bucket of the partial leaves
    (``step_fn.model_log``), and the forward and backward ones the
    count :func:`tp_calls` sets out for each family;
  * the backward of every collective of ``models.tp`` and the
    vocab-parallel cross entropy against the unsharded gradient.

MoE near-ties are counted and printed (``-s``), never re-seeded away.
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
MODE_ARCHS = ("llama3.2-1b", "granite-moe-3b-a800m", "minicpm3-4b",
              "hymba-1.5b")
SP_OFF = {"1x2": ("llama3.2-1b", "hymba-1.5b"),
          "2x2": ("llama3.2-1b", "hymba-1.5b"), "1x3": ("llama3.2-1b",)}
ROWS, STEPS, AGGR = 2, 3, 1 << 12
PEAK_LR = 1e-3
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)   # test_torch_train_families.py
PORT_TOL = 1e-5
LOSS_RTOL = 1e-5
ZERO_REL = 1e-5
NOISE_STEPS = 2 * STEPS
AUTOGRAD_TOL = 1e-5
TIMEOUT_S = 240


def port_config(arch):
    from repro_torch.configs import get_smoke_config
    return get_smoke_config(arch).replace(param_dtype="float32")


def seq_len(cfg) -> int:
    return 96 if cfg.frontend == "vision_stub" else 24


def refused(arch, m) -> bool:
    cfg = port_config(arch)
    return cfg.mamba is not None and cfg.mamba.n_heads(cfg.d_model) % m != 0


def variants(name, arch):
    """(mode, seq_parallel, steps) of each run of an arch on a mesh: the
    3-step partitioned run first."""
    out = [("partitioned", True, STEPS)]
    if arch in MODE_ARCHS:
        out += [("bulk", True, 1), ("per_leaf", True, 1)]
    if arch in SP_OFF[name]:
        out.append(("partitioned", False, 1))
    return out


def vkey(arch, mode, sp):
    return f"{arch}-{mode}-sp{int(sp)}"


def shard_batches(cfg, index: int, count: int):
    """Data shard ``index`` of ``count`` (``ROWS`` rows each) of the
    first ``STEPS`` global batches, NumPy."""
    from repro_torch.data import pipeline
    s = seq_len(cfg)
    stream = pipeline.for_model(cfg, s, ROWS * count, host_index=index,
                                host_count=count)
    out = []
    for i in range(STEPS):
        b = stream.batch(i)
        if cfg.mrope_sections is not None:
            b["positions"] = pipeline.grid_positions(ROWS, s, 1, 8, 8)
        out.append(b)
    return out


def step_config(mode="partitioned", sp=True):
    from repro_torch.launch.steps import StepConfig
    return StepConfig(sync_mode=mode, aggr_bytes=AGGR,
                      param_dtype="float32", peak_lr=PEAK_LR,
                      warmup_steps=1, total_steps=10, seq_parallel=sp)


def tp_calls(cfg, sp: bool) -> dict:
    """The model-axis collectives of one step's forward and backward
    (the gradient sum, the clip norm's all-reduce and the data axes
    apart), from the design: each mixer and FFN input enters the
    tensor-parallel region (all-reduce backward; with ``sp`` an
    all-gather along the sequence, reduce-scatter backward), each
    output leaves it (all-reduce forward, identity backward; with
    ``sp`` a reduce-scatter, all-gather backward; the hybrid's two
    mixers in one), and the Mamba gated norm's sums of squares are an
    all-reduce both ways.  With remat each layer's forward runs again
    in backward up to its last saved tensor (torch's non-reentrant
    checkpoint stops there): every collective but the layer's last
    output, which nothing in the layer saves unless a post norm reads
    it.  The token embedding leaves like an output (the audio stub's
    frames are sliced, not reduced), the final hidden enters like an
    input, and the vocab-parallel loss makes two all-reduces a chunk
    (the maxima and the stacked sums), again in its checkpointed
    recomputation."""
    ffn = cfg.d_ff > 0 or cfg.moe is not None
    ins = outs = 1 + ffn
    redo = outs - (0 if cfg.post_norm else 1)
    gated = 3 * (cfg.mixer in ("mamba", "hybrid"))
    emb = cfg.frontend != "audio_stub"
    s = seq_len(cfg)
    chunk = min(cfg.loss_chunk, s)
    ce = 4 * (s // chunk) + 2 * (s % chunk > 0)
    L = cfg.n_layers
    if sp:
        return {"all_reduce": L * gated + ce,
                "all_gather": L * (2 * ins + outs) + emb + 1,
                "reduce_scatter": L * (outs + redo + ins) + emb + 1}
    return {"all_reduce": L * (outs + redo + ins + gated) + emb + 1 + ce,
            "all_gather": 0, "reduce_scatter": 0}


def _router_ties(torch, cfg, model, batch, tp):
    """Tokens whose router gap at the k-th expert is under 1e-5."""
    from repro_torch.models import lm, moe
    rec, real = [], moe.router_top_k

    def spy(p, xc, mo):
        rec.append((xc @ p.router.to(xc.dtype)).float()[:, :mo.n_experts])
        return real(p, xc, mo)
    moe.router_top_k = spy
    try:
        with torch.no_grad():
            lm.forward(cfg, model, batch, tp=tp)
    finally:
        moe.router_top_k = real
    k, ties = cfg.moe.top_k, 0
    for r in rec:
        srt = np.sort(r.numpy(), axis=-1)[:, ::-1]
        ties += int((srt[:, k - 1] - srt[:, k] < 1e-5).sum())
    return ties


def _autograd_checks(torch, tp) -> dict:
    """Max |d grad| of each collective's backward against the unsharded
    gradient, every rank computing the same loss from the same seeded
    tensors (its own blocks cut from them)."""
    import torch.nn.functional as F

    from repro_torch.models import tp as tpc
    from repro_torch.models.layers import chunked_cross_entropy
    m, r = tp.size, tp.rank
    g = torch.Generator().manual_seed(5)
    b, s, d, f, v = 2 * m, 6 * m, 4 * m, 4 * m, 5 * m
    x = torch.randn((b, s, d), generator=g)
    w1 = torch.randn((d, f), generator=g)
    w2 = torch.randn((f, d), generator=g)
    c = torch.randn((b, s, d), generator=g)
    cols = slice(r * f // m, (r + 1) * f // m)
    seq = slice(r * s // m, (r + 1) * s // m)

    def leaf(t):
        return t.clone().requires_grad_(True)

    def err(a, want):
        return float((a - want).abs().max())
    out = {}

    # column- then row-parallel: enter, reduce (and psum in a gated norm)
    for name in ("enter_reduce", "psum"):
        xs, w1s, w2s = leaf(x), leaf(w1[:, cols]), leaf(w2[cols])
        xu, w1u, w2u = leaf(x), leaf(w1), leaf(w2)
        z, zu = tpc.enter(xs, tp) @ w1s, xu @ w1u
        if name == "psum":
            z = z * torch.rsqrt(tpc.psum(z.square().sum(-1, keepdim=True),
                                         tp))
            zu = zu * torch.rsqrt(zu.square().sum(-1, keepdim=True))
        y = tpc.reduce(F.silu(z) @ w2s, tp)
        (y * c).sum().backward()
        (((F.silu(zu) @ w2u) * c).sum()).backward()
        out[name] = max(err(xs.grad, xu.grad),
                        err(w1s.grad, w1u.grad[:, cols]),
                        err(w2s.grad, w2u.grad[cols]))

    # the sequence-parallel stream: gather_seq in, scatter_seq out; each
    # rank owns its block of the output, the loss the sum of the blocks'
    xs, w1s, w2s = leaf(x[:, seq]), leaf(w1[:, cols]), leaf(w2[cols])
    xu, w1u, w2u = leaf(x), leaf(w1), leaf(w2)
    y = tpc.scatter_seq(F.silu(tpc.gather_seq(xs, tp) @ w1s) @ w2s, tp)
    (y * c[:, seq]).sum().backward()
    ((F.silu(xu @ w1u) @ w2u) * c).sum().backward()
    out["gather_scatter_seq"] = max(err(xs.grad, xu.grad[:, seq]),
                                    err(w1s.grad, w1u.grad[:, cols]),
                                    err(w2s.grad, w2u.grad[cols]))

    # all-gathers whose backward keeps this rank's block: every rank
    # computes the same loss from the gathered tensor
    rows = tpc.TP(group=tp.group, size=m, rank=r, rows_group=tp.group)
    for name, fn, dim in (("gather_vocab", tpc.gather_vocab, 2),
                          ("gather_heads", tpc.gather_heads, 1),
                          ("gather_rows", tpc.gather_rows, 0)):
        n = x.shape[dim] // m
        xs, xu = leaf(x.narrow(dim, r * n, n)), leaf(x)
        (fn(xs, rows if name == "gather_rows" else tp).sin() * c).sum() \
            .backward()
        (xu.sin() * c).sum().backward()
        out[name] = err(xs.grad, xu.grad.narrow(dim, r * n, n))

    # the vocab-parallel cross entropy (padding masked, both target rules)
    head = torch.randn((d, v), generator=g)
    labels = torch.randint(0, v - 2, (b, s), generator=g)
    vb = slice(r * v // m, (r + 1) * v // m)
    for gt in (False, True):
        hs, ws = leaf(x), leaf(head[:, vb])
        hu, wu = leaf(x), leaf(head)
        ls = chunked_cross_entropy(tpc.enter(hs, tp), ws, labels, chunk=4,
                                   valid_vocab=v - 1, gather_targets=gt,
                                   final_softcap=3.0, tp=tp)
        lu = chunked_cross_entropy(hu, wu, labels, chunk=4,
                                   valid_vocab=v - 1, gather_targets=gt,
                                   final_softcap=3.0)
        ls.backward()
        lu.backward()
        out[f"cross_entropy_gt{int(gt)}"] = max(
            err(ls.detach(), lu.detach()), err(hs.grad, hu.grad),
            err(ws.grad, wu.grad[:, vb]))
    return out


def _keep(trees, key, tree):
    """Keep a JAX-layout tree's leaves under ``key/leaf``."""
    from repro_torch.models import convert
    for leaf, a in convert.jax_to_leaves(tree).items():
        trees[f"{key}/{leaf}"] = a


def rank_main(name: str, rank: int, n: int, store_path: str,
              out_dir: str) -> None:
    import torch
    from repro_torch import compat
    from repro_torch.launch import mesh as pmesh
    from repro_torch.launch import steps
    from repro_torch.models import convert, lm
    from repro_torch.models import tp as tpc
    torch.set_num_threads(1)
    dist = gloo_rank(rank, n, store_path)
    dp, m = MESHES[name]
    report, trees = {}, {}
    try:
        mesh = pmesh.make_mesh((dp, m), ("data", "model"), "cpu")
        di = pmesh.axis_index(mesh, pmesh.dp_axes(mesh))
        dp_group = pmesh.axis_group(mesh, pmesh.dp_axes(mesh))
        tp = tpc.from_mesh(mesh)
        report["autograd"] = _autograd_checks(torch, tp)
        for arch in ARCHS:
            cfg = port_config(arch)
            s = seq_len(cfg)
            if refused(arch, m):
                try:
                    steps.make_train_step(cfg, step_config(), seq_len=s,
                                          batch=ROWS * dp, device="cpu",
                                          mesh=mesh)
                    report[f"{arch}-refused"] = "no error"
                except NotImplementedError as e:
                    report[f"{arch}-refused"] = str(e)
                continue
            cfg_tp = cfg.with_tp(m)
            data = [steps.batch_to_device(b, "cpu")
                    for b in shard_batches(cfg, di, dp)]
            if pmesh.axis_index(mesh, "model") == 0:
                # the unsharded step on the same rows, synced over the
                # data axes (the ranks of model index 0 run it)
                plain = steps.build_state(cfg_tp, 0, "cpu")
                ustep = steps.make_train_step(cfg_tp, step_config(),
                                              seq_len=s, batch=ROWS,
                                              device="cpu", group=dp_group)
                u_loss = []
                for i, b in enumerate(data):
                    plain, loss = ustep(plain, b)
                    u_loss.append(float(loss))
                    if i == 0 and rank == 0:
                        _keep(trees, f"{arch}-plain", convert.named_to_jax(
                            {k: p.grad for k, p in
                             plain["params"].named_parameters()}))
                report[f"{arch}-plain-losses"] = u_loss
                if rank == 0:
                    _keep(trees, f"{arch}-plain-params", convert.named_to_jax(
                        dict(plain["params"].named_parameters())))
                del plain
            if cfg.moe is not None:
                report[f"{arch}-ties"] = _router_ties(
                    torch, cfg_tp, steps.build_state(cfg, 0, "cpu",
                                                     mesh=mesh)["params"],
                    data[0], tp)
            for mode, sp, n_steps in variants(name, arch):
                key = vkey(arch, mode, sp)
                state = steps.build_state(cfg, 0, "cpu", mesh=mesh)
                step = steps.make_train_step(cfg, step_config(mode, sp),
                                             seq_len=s, batch=ROWS * dp,
                                             device="cpu", mesh=mesh)
                losses = []
                for i, b in enumerate(data[:n_steps]):
                    before = dict(compat.CALLS)
                    state, loss = step(state, b)
                    losses.append(float(loss))
                    if i:
                        continue
                    calls = {k: compat.CALLS[k] - before[k] for k in before}
                    rec = {"calls": calls, "data": step.log.count(),
                           "model_sum": step.model_log.count()}
                    gtree = convert.tp_named_to_jax(
                        {k: p.grad for k, p in
                         state["params"].named_parameters()}, cfg_tp, mesh)
                    if rank == 0:
                        _keep(trees, key, gtree)
                if n_steps == STEPS:
                    ptree = convert.tp_named_to_jax(
                        dict(state["params"].named_parameters()), cfg_tp,
                        mesh)
                    if rank == 0:
                        _keep(trees, f"{key}-params", ptree)
                    rec["losses"] = losses
                    specs = steps.opt_specs(cfg_tp, mesh)["m"]
                    rec["zero1"] = {
                        leaf: [list(t.to_local().shape), list(t.shape),
                               [e if e is None else list(pmesh.spec_axes(e))
                                for e in specs[leaf]],
                               [str(p) for p in t.placements]]
                        for leaf, t in state["opt"]["m"].items()}
                    rec["zero1_ag"] = sum("data" in tuple(specs[leaf])
                                          for leaf in specs)
                    rec["local_shapes"] = {
                        k: [len(v), *v[0].shape] if k.startswith("layers.")
                        else list(v[0].shape)
                        for k, v in lm.param_leaves(
                            state["params"].named_parameters())}
                report[key] = rec
    finally:
        with open(os.path.join(out_dir, f"{name}-rank{rank}.json"),
                  "w") as fh:
            json.dump(report, fh)
        if trees:
            np.savez(os.path.join(out_dir, f"{name}-trees.npz"), **trees)
        dist.destroy_process_group()


def jax_main(m: int, out_dir: str) -> None:
    """JAX at ``with_tp(m)`` from the port's seeded model: per arch and
    data-parallel degree of the meshes with this M, the step-0 gradients
    (the mean of the data shards' ``value_and_grad``) and the losses of
    the 3-step chain through ``adamw_update`` and ``warmup_cosine``."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import lm as jlm
    from repro.optim import adamw as jadamw
    from repro.optim.schedule import warmup_cosine
    from repro_torch.launch import steps
    from repro_torch.models import convert
    out = {}
    dps = sorted({dp for dp, mm in MESHES.values() if mm == m})
    scfg = step_config()
    for arch in ARCHS:
        if refused(arch, m):
            continue
        cfg = port_config(arch)
        jc = jconfigs.get_smoke_config(arch).with_tp(m).replace(
            param_dtype="float32")
        model = steps.build_state(cfg.with_tp(m), 0, "cpu")["params"]
        params0 = jax.tree.map(jnp.asarray, convert.named_to_jax(
            dict(model.named_parameters())))
        vg = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(jc, p, b)))

        @jax.jit
        def update(params, grads, opt):
            grads = jax.tree.map(lambda *gs: sum(gs) / len(gs), *grads)
            lr = warmup_cosine(opt["step"], peak_lr=scfg.peak_lr,
                               warmup_steps=scfg.warmup_steps,
                               total_steps=scfg.total_steps)
            return jadamw.adamw_update(params, grads, opt, lr,
                                       jadamw.AdamWConfig())
        for dp in dps:
            shards = [shard_batches(cfg, i, dp) for i in range(dp)]
            params = params0
            opt = jadamw.init_opt_state(params, jadamw.AdamWConfig())
            losses = []
            for t in range(STEPS):
                res = [vg(params, {k: jnp.asarray(v) for k, v in
                                   sh[t].items()}) for sh in shards]
                losses.append(sum(float(r[0]) for r in res) / dp)
                if t == 0:
                    for leaf in convert.jax_to_leaves(res[0][1]):
                        out[f"{arch}-dp{dp}/{leaf}"] = sum(
                            np.asarray(convert.jax_to_leaves(r[1])[leaf])
                            for r in res) / dp
                params, opt = update(params, [r[1] for r in res], opt)
            out[f"{arch}-dp{dp}-losses"] = np.asarray(losses)
    np.savez(os.path.join(out_dir, f"jax-{m}.npz"), **out)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_train")
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
    trees = {name: dict(np.load(out / f"{name}-trees.npz"))
             for name in MESHES}
    jax_out = {m: dict(np.load(out / f"jax-{m}.npz"))
               for m in sorted({m for _, m in MESHES.values()})}
    return reports, trees, jax_out


CASES = [(name, arch, mode, sp) for name, (_, m) in MESHES.items()
         for arch in ARCHS if not refused(arch, m)
         for mode, sp, _ in variants(name, arch)]
IDS = [f"{n}-{vkey(a, mo, sp)}" for n, a, mo, sp in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_step0_grads_meet_jax(results, case):
    name, arch, mode, sp = case
    reports, trees, jax_out = results
    dp, m = MESHES[name]
    key, want = vkey(arch, mode, sp), jax_out[m]
    prefix = f"{arch}-dp{dp}/"
    leaves = [k[len(prefix):] for k in want if k.startswith(prefix)]
    assert leaves
    for leaf in leaves:
        np.testing.assert_allclose(trees[name][f"{key}/{leaf}"],
                                   want[prefix + leaf], **GRAD_TOL,
                                   err_msg=f"{name} {key}: {leaf}")
    ties = reports[name][0].get(f"{arch}-ties")
    if ties is not None:
        print(f"{name} {arch}: {ties} MoE near-tie tokens")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_step0_grads_meet_the_unsharded_step(results, case):
    """The reassembled blocks within ``PORT_TOL`` (absolute and
    relative) of the unsharded step's synced gradients."""
    name, arch, mode, sp = case
    _, trees, _ = results
    got, key = trees[name], vkey(arch, mode, sp)
    prefix = f"{arch}-plain/"
    leaves = [k[len(prefix):] for k in got if k.startswith(prefix)]
    assert leaves
    for leaf in leaves:
        np.testing.assert_allclose(got[f"{key}/{leaf}"], got[prefix + leaf],
                                   rtol=PORT_TOL, atol=PORT_TOL,
                                   err_msg=f"{name} {key}: {leaf}")


RUNS = [(name, arch) for name, (_, m) in MESHES.items() for arch in ARCHS
        if not refused(arch, m)]


@pytest.mark.parametrize("run", RUNS, ids=[f"{n}-{a}" for n, a in RUNS])
def test_three_steps_meet_jax_and_the_unsharded_step(results, run):
    name, arch = run
    reports, trees, jax_out = results
    dp, m = MESHES[name]
    want = jax_out[m][f"{arch}-dp{dp}-losses"]
    key = vkey(arch, "partitioned", True)
    first = reports[name][0][key]["losses"]
    for rep in reports[name]:
        assert rep[key]["losses"] == first
    np.testing.assert_allclose(first, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(first, reports[name][0][f"{arch}-plain-losses"],
                               rtol=LOSS_RTOL)
    got, prefix = trees[name], f"{arch}-plain-params/"
    leaves = [k[len(prefix):] for k in got if k.startswith(prefix)]
    assert leaves
    grad0 = {leaf: got[f"{arch}-plain/{leaf}"] for leaf in leaves}
    zero = ZERO_REL * max(np.abs(g).max() for g in grad0.values())
    for leaf in leaves:
        d = np.abs(got[f"{key}-params/{leaf}"] - got[prefix + leaf])
        exempt = np.abs(grad0[leaf]) <= zero
        for i in np.argwhere(exempt & (d > PORT_TOL)):
            i = tuple(int(j) for j in i)
            print(f"{name} {arch}: {leaf}{list(i)}, step-0 gradient"
                  f" {grad0[leaf][i]:.3e} (zero to {zero:.3e}), off by"
                  f" {d[i]:.3e}")
        np.testing.assert_array_less(d[~exempt], PORT_TOL * (1 + 1e-6),
                                     err_msg=f"{name} {arch}: {leaf}")
        assert d.max() <= NOISE_STEPS * PEAK_LR, leaf


def _jax_buckets(local_shapes, mode: str) -> int:
    """Buckets of JAX's ``make_plan`` over a rank's local f32 leaves:
    the whole tree at 256 MiB (bulk) or 0 (per_leaf); each layer's
    leaves, then the rest, at ``AGGR`` (partitioned)."""
    import jax
    import jax.numpy as jnp

    from repro.core import bucketing as jb

    def struct(shape):
        return jax.ShapeDtypeStruct(tuple(shape), jnp.float32)
    leaves = [struct(s) for s in local_shapes.values()]
    if mode != "partitioned":
        aggr = 256 << 20 if mode == "bulk" else 0
        return jb.make_plan(leaves, aggr).n_buckets
    layer = [struct(s[1:]) for k, s in local_shapes.items()
             if k.startswith("layers.")]
    rest = [struct(s) for k, s in local_shapes.items()
            if not k.startswith("layers.")]
    n_layers = next(s[0] for k, s in local_shapes.items()
                    if k.startswith("layers."))
    return (n_layers * jb.make_plan(layer, AGGR).n_buckets
            + jb.make_plan(rest, AGGR).n_buckets)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_collectives_a_step(results, case):
    """Step 0's collectives (``compat.CALLS``): the data-axis
    all-reduces = JAX's plan over the local leaves + 1 (the loss); the
    model-axis gradient sum = the plan of the partial leaves at
    ``AGGR``; one all-reduce for the clip norm; one all-gather a leaf
    whose moment splits over the data axes (``zero1_update``); the
    forward and backward as :func:`tp_calls`."""
    import jax
    import jax.numpy as jnp

    from repro.core import bucketing as jb
    from repro_torch.models import lm
    name, arch, mode, sp = case
    reports, _, _ = results
    cfg = port_config(arch)
    for rep in reports[name]:
        run = rep[vkey(arch, "partitioned", True)]
        shapes = run["local_shapes"]
        rec = rep[vkey(arch, mode, sp)]
        assert rec["data"] == _jax_buckets(shapes, mode) + 1
        partial = [jax.ShapeDtypeStruct(tuple(shapes[k]), jnp.float32)
                   for k in lm.partial_grad_leaves(
                       cfg.with_tp(MESHES[name][1]), sp)]
        assert partial
        assert rec["model_sum"] == jb.make_plan(partial, AGGR).n_buckets
        want = tp_calls(cfg, sp)
        got = rec["calls"]
        assert got["all_reduce"] == (want["all_reduce"] + rec["data"]
                                     + rec["model_sum"] + 1)
        assert got["all_gather"] == want["all_gather"] + run["zero1_ag"]
        assert got["reduce_scatter"] == want["reduce_scatter"]


@pytest.mark.parametrize("name", MESHES)
def test_collective_backwards_meet_the_unsharded_gradient(results, name):
    reports, _, _ = results
    for rep in reports[name]:
        assert len(rep["autograd"]) == 8
        for fn, e in rep["autograd"].items():
            assert e <= AUTOGRAD_TOL, (fn, e)


@pytest.mark.parametrize("name", MESHES)
def test_zero1_moments_split_over_every_axis(results, name):
    """Each moment is a DTensor of the whole leaf placed by
    ``opt_state_specs`` (its spec's axes sharded, the others
    replicated), and each rank allocates only its (model, data) block:
    its parameter block with the data-split dim cut over the data axes;
    some leaf of every arch splits over both."""
    reports, _, _ = results
    dp, m = MESHES[name]
    for rep in reports[name]:
        for arch in ARCHS:
            if refused(arch, m):
                continue
            run = rep[vkey(arch, "partitioned", True)]
            both = 0
            for leaf, (local, whole, spec, places) in run["zero1"].items():
                want = list(run["local_shapes"][leaf])
                axes = [a for e in spec if e for a in e]
                assert sorted(axes) == sorted(set(axes))
                shards = [p for p in places if p.startswith("S(")]
                assert len(shards) == len(axes), (leaf, places)
                for d, e in enumerate(spec):
                    if e and "data" in e:
                        assert want[d] % dp == 0
                        want[d] //= dp
                assert local == want, (arch, leaf)
                assert whole == _whole(arch, m, leaf)
                both += "data" in axes and "model" in axes
            assert both > 0, arch


def _whole(arch, m, leaf):
    from repro_torch.models import lm
    return list(lm.param_shapes(port_config(arch).with_tp(m))[leaf])


@pytest.mark.parametrize("arch", [a for a in ARCHS if refused(a, 3)])
def test_mamba_heads_that_do_not_split_are_refused(results, arch):
    reports, _, _ = results
    for rep in reports["1x3"]:
        assert "do not split evenly over 3 model ranks" in \
            rep[f"{arch}-refused"]
        assert "ZeRO-1 moments" in rep[f"{arch}-refused"]


def test_partial_leaves_are_the_replicated_ones():
    """The replicated leaves read inside a tensor-parallel region are
    partial whatever the stream; the stream norms only when it is split
    along the sequence."""
    from repro_torch.models import lm
    cfg = port_config("hymba-1.5b").with_tp(2)
    off = set(lm.partial_grad_leaves(cfg, False))
    on = set(lm.partial_grad_leaves(cfg, True))
    assert on - off == {n for n in lm.STREAM_NORMS
                        if n in lm.param_shapes(cfg)}
    assert {"layers.attn.wk", "layers.attn.wv", "layers.mamba.w_B",
            "layers.mamba.A_log", "layers.mamba.dt_bias"} <= off
    assert not {"embed", "layers.attn.wq", "layers.mamba.w_x",
                "layers.mlp.w_up"} & on
    moe = lm.partial_grad_leaves(port_config("granite-moe-3b-a800m")
                                 .with_tp(2), False)
    assert "layers.moe.router" in moe
    mla = lm.partial_grad_leaves(port_config("minicpm3-4b").with_tp(2),
                                 False)
    assert {"layers.attn.w_dq", "layers.attn.norm_q", "layers.attn.w_dkv",
            "layers.attn.norm_kv", "layers.attn.w_kr"} == set(mla)


if __name__ == "__main__":
    if sys.argv[1] == "rank":
        rank_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5], sys.argv[6])
    else:
        jax_main(int(sys.argv[2]), sys.argv[3])
