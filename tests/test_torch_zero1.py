"""ZeRO-1 on the port's mesh, on ``gloo`` ranks in subprocesses (this
file is also the rank's program).

On 8 and 3 ranks, a ``(dp, 1)`` mesh, the llama3.2-1b and granite-moe
smoke configs at 3 layers (so that the stacked layer axis splits over 3
ranks; no other dim of theirs does) in f32, a global batch of 24 rows of 32 tokens split over
the data axis: three steps of ``make_train_step(..., mesh=mesh)`` (the
early-bird sync over the data axis, each rank keeping only its block of
the AdamW moments and updating only that block of the parameters before
the all-gather) against three steps of the unsharded step on the same
ranks, the same data and the same seed (``make_train_step`` without a
mesh: every rank holds the whole moments).

  * the parameters, the losses and the gathered moments are bitwise
    equal to the unsharded step's;
  * each rank holds ``1/dp`` of every leaf that ``zero1_spec`` shards,
    and the whole of the others;
  * the gathered moments and the losses of llama3.2-1b meet JAX's
    ``make_train_step`` on a one-device mesh on the whole global batch
    within the tolerance of ``tests/test_torch_train.py`` (``rtol``
    1e-5, with an ``atol`` of 1e-5 of the leaf's largest moment for the
    moments, whose elements near zero carry the data-parallel sum's
    rounding).

A checkpoint saved on 4 ranks after two ZeRO-1 steps (the moments
gathered whole, rank 0 writing) and restored with the 3-rank mesh's
shardings holds the saved values, a third of each sharded moment on
each rank, and its next step equals bitwise the unsharded step's from
the same checkpoint restored without shardings.
"""

import json
import os
import sys

import numpy as np
import pytest

from _ranks import finish, gloo_rank, spawn

WORLDS = (8, 3)
ARCHS = ("llama3.2-1b", "granite-moe-3b-a800m")
GB, S, STEPS = 24, 32, 3
LAYERS = 3
CKPT_FROM, CKPT_TO, CKPT_STEPS = 4, 3, 2
TIMEOUT_S = 240
MOMENT_RTOL = LOSS_RTOL = 1e-5


def scfg():
    from repro_torch.launch.steps import StepConfig
    return StepConfig(sync_mode="partitioned", aggr_bytes=1 << 12,
                      param_dtype="float32", peak_lr=1e-3, warmup_steps=1,
                      total_steps=10)


def port_config(arch):
    from repro_torch.configs import get_smoke_config
    return get_smoke_config(arch).replace(param_dtype="float32",
                                          n_layers=LAYERS)


def batches(cfg, index: int, count: int, steps: int, first: int = 0):
    """This rank's rows of every step's global batch, as tensors."""
    from repro_torch.data import pipeline
    from repro_torch.launch.steps import batch_to_device
    stream = pipeline.for_model(cfg, S, GB, host_index=index,
                                host_count=count)
    return [batch_to_device(stream.batch(i), "cpu")
            for i in range(first, first + steps)]


def mesh_of(n):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((n, 1), ("data", "model"), "cpu")


def params_of(state):
    return {k: p.detach().clone() for k, p in
            state["params"].named_parameters()}


def train_main(rank: int, n: int, store_path: str, out_dir: str) -> None:
    """ZeRO-1 and unsharded steps on ``n`` ranks; writes the comparison
    and, from rank 0, the gathered moments."""
    import torch
    from repro_torch.launch import steps as psteps
    from repro_torch.models import convert
    dist = gloo_rank(rank, n, store_path)
    report = {}
    try:
        mesh = mesh_of(n)
        for arch in ARCHS:
            cfg = port_config(arch)
            data = batches(cfg, rank, n, STEPS)
            sharded = psteps.build_state(cfg, 0, "cpu", mesh=mesh)
            plain = psteps.build_state(cfg, 0, "cpu")
            step_z = psteps.make_train_step(cfg, scfg(), seq_len=S,
                                            batch=GB, device="cpu",
                                            mesh=mesh)
            step_u = psteps.make_train_step(cfg, scfg(), seq_len=S,
                                            batch=GB // n, device="cpu")
            lz, lu = [], []
            for b in data:
                sharded, loss = step_z(sharded, b)
                lz.append(float(loss))
                plain, loss = step_u(plain, b)
                lu.append(float(loss))
            pz, pu = params_of(sharded), params_of(plain)
            mz = {k: convert.moments_to_jax(sharded["opt"][k])
                  for k in ("m", "v")}
            mu = {k: convert.moments_to_jax(plain["opt"][k])
                  for k in ("m", "v")}
            flat = {k: dict(convert.jax_to_leaves(mz[k])) for k in mz}
            flat_u = {k: dict(convert.jax_to_leaves(mu[k])) for k in mu}
            specs = psteps.opt_specs(cfg, mesh)["m"]
            local = {}
            for leaf, t in sharded["opt"]["m"].items():
                local[leaf] = [t.to_local().numel(), t.numel(),
                               "data" in tuple(specs[leaf])]
            report[arch] = {
                "losses": lz, "losses_plain": lu,
                "params_equal": all(torch.equal(pz[k], pu[k]) for k in pz),
                "moments_equal": all(
                    np.array_equal(flat[k][leaf], flat_u[k][leaf])
                    for k in flat for leaf in flat[k]),
                "local": local,
            }
            if rank == 0:
                np.savez(os.path.join(out_dir, f"moments{n}-{arch}.npz"),
                         **{f"{k}/{leaf}": a for k in flat
                            for leaf, a in flat[k].items()})
    finally:
        with open(os.path.join(out_dir, f"train{n}-{rank}.json"),
                  "w") as fh:
            json.dump(report, fh)
        dist.destroy_process_group()


def save_main(rank: int, n: int, store_path: str, out_dir: str) -> None:
    """Two ZeRO-1 steps on ``n`` ranks, then a checkpoint (rank 0
    writes the gathered tree)."""
    from repro_torch.ckpt import checkpoint as pckpt
    from repro_torch.launch import steps as psteps
    from repro_torch.models import convert
    dist = gloo_rank(rank, n, store_path)
    try:
        cfg = port_config(ARCHS[0])
        mesh = mesh_of(n)
        state = psteps.build_state(cfg, 0, "cpu", mesh=mesh)
        step = psteps.make_train_step(cfg, scfg(), seq_len=S, batch=GB,
                                      device="cpu", mesh=mesh)
        for b in batches(cfg, rank, n, CKPT_STEPS):
            state, _ = step(state, b)
        tree = convert.state_to_jax(state)
        if rank == 0:
            pckpt.save(os.path.join(out_dir, "ckpt"), CKPT_STEPS, tree)
    finally:
        dist.destroy_process_group()


def restore_main(rank: int, n: int, store_path: str, out_dir: str) -> None:
    """Restore the checkpoint onto ``n`` ranks with and without the
    mesh's shardings; one more step each."""
    import torch
    from repro_torch.ckpt import checkpoint as pckpt
    from repro_torch.launch import steps as psteps
    from repro_torch.models import convert
    dist = gloo_rank(rank, n, store_path)
    report = {}
    try:
        cfg = port_config(ARCHS[0])
        mesh = mesh_of(n)
        ckpt = os.path.join(out_dir, "ckpt")
        template = convert.state_to_jax(psteps.build_state(cfg, 0, "cpu"))
        step_no, tree = pckpt.restore(
            ckpt, template, shardings={"opt": psteps.opt_shardings(cfg,
                                                                   mesh)})
        sharded = convert.state_from_jax(tree, cfg, device="cpu")
        _, host = pckpt.restore(ckpt, template)
        plain = convert.state_from_jax(host, cfg, device="cpu")
        report["step"] = step_no
        saved = dict(convert.jax_to_leaves(host["opt"]["m"]))
        report["restored_equal"] = all(
            np.array_equal(t.full_tensor().numpy(), saved[leaf])
            for leaf, t in sharded["opt"]["m"].items())
        specs = psteps.opt_specs(cfg, mesh)["m"]
        report["local"] = {leaf: [t.to_local().numel(), t.numel(),
                                  "data" in tuple(specs[leaf])]
                           for leaf, t in sharded["opt"]["v"].items()}
        b, = batches(cfg, rank, n, 1, first=CKPT_STEPS)
        step_z = psteps.make_train_step(cfg, scfg(), seq_len=S, batch=GB,
                                        device="cpu", mesh=mesh)
        step_u = psteps.make_train_step(cfg, scfg(), seq_len=S,
                                        batch=GB // n, device="cpu")
        sharded, lz = step_z(sharded, b)
        plain, lu = step_u(plain, b)
        pz, pu = params_of(sharded), params_of(plain)
        report["losses"] = [float(lz), float(lu)]
        report["params_equal"] = all(torch.equal(pz[k], pu[k]) for k in pz)
        report["opt_step"] = int(sharded["opt"]["step"])
    finally:
        with open(os.path.join(out_dir, f"restore-{rank}.json"), "w") as fh:
            json.dump(report, fh)
        dist.destroy_process_group()


def jax_moments():
    """JAX's make_train_step on a one-device mesh, on the whole global
    batch, from the port's seed-0 parameters: losses and moments."""
    import jax
    import jax.numpy as jnp

    from repro.compat import set_mesh
    from repro.configs import get_smoke_config as jsmoke
    from repro.data import pipeline as jpipe
    from repro.launch import steps as jsteps
    from repro.optim import adamw as jadamw
    from repro.runtime import elastic
    from repro_torch.launch import steps as psteps
    from repro_torch.models import convert
    out = {}
    arch = ARCHS[0]
    jc = jsmoke(arch).replace(param_dtype="float32", n_layers=LAYERS)
    model = psteps.build_state(port_config(arch), 0, "cpu")["params"]
    params = jax.tree.map(jnp.asarray, convert.named_to_jax(
        dict(model.named_parameters())))
    mesh = elastic.build_mesh(elastic.plan_mesh(1, 1))
    p = scfg()
    jscfg = jsteps.StepConfig(
        sync_mode=p.sync_mode, aggr_bytes=p.aggr_bytes,
        param_dtype=p.param_dtype, peak_lr=p.peak_lr,
        warmup_steps=p.warmup_steps, total_steps=p.total_steps)
    stream = jpipe.for_model(jc, S, GB)
    with set_mesh(mesh):
        step_fn, *_ = jsteps.make_train_step(jc, mesh, jscfg, seq_len=S,
                                             global_batch=GB)
        step = jax.jit(step_fn)
        state = {"params": params,
                 "opt": jadamw.init_opt_state(params, jadamw.AdamWConfig())}
        losses = []
        for i in range(STEPS):
            state, loss = step(state, {k: jnp.asarray(v) for k, v in
                                       stream.batch(i).items()})
            losses.append(float(loss))
    out["losses"] = losses
    for k in ("m", "v"):
        out[k] = {leaf: np.asarray(a) for leaf, a in convert.jax_to_leaves(
            jax.tree.map(np.asarray, state["opt"][k])).items()}
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("zero1")
    procs = []
    for n in WORLDS:
        procs += [spawn(__file__, "train", r, n, out / f"store{n}", out)
                  for r in range(n)]
    procs += [spawn(__file__, "save", r, CKPT_FROM, out / "store-save", out)
              for r in range(CKPT_FROM)]
    jax_side = finish(procs, TIMEOUT_S, while_running=jax_moments)
    finish([spawn(__file__, "restore", r, CKPT_TO, out / "store-restore",
                  out) for r in range(CKPT_TO)], TIMEOUT_S)

    def load(name):
        return json.loads((out / name).read_text())
    return {
        "train": {n: [load(f"train{n}-{r}.json") for r in range(n)]
                  for n in WORLDS},
        "moments": {(n, a): dict(np.load(out / f"moments{n}-{a}.npz"))
                    for n in WORLDS for a in ARCHS},
        "restore": [load(f"restore-{r}.json") for r in range(CKPT_TO)],
        "jax": jax_side,
    }


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_equals_unsharded_step_bitwise(results, n, arch):
    for rep in results["train"][n]:
        got = rep[arch]
        assert got["params_equal"]
        assert got["moments_equal"]
        assert got["losses"] == got["losses_plain"]
    first = results["train"][n][0][arch]["losses"]
    for rep in results["train"][n]:
        assert rep[arch]["losses"] == first


def _assert_blocks(local, dp):
    sharded = 0
    for leaf, (mine, whole, split) in local.items():
        if split:
            assert mine * dp == whole, leaf
            sharded += 1
        else:
            assert mine == whole, leaf
    assert sharded > 0


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_share_of_the_moments(results, n, arch):
    for rep in results["train"][n]:
        _assert_blocks(rep[arch]["local"], n)


@pytest.mark.parametrize("n", WORLDS)
def test_moments_meet_jax(results, n):
    want = results["jax"]
    got = results["moments"][(n, ARCHS[0])]
    for k in ("m", "v"):
        assert {f"{k}/{leaf}" for leaf in want[k]} <= set(got)
        for leaf, w in want[k].items():
            g = got[f"{k}/{leaf}"]
            np.testing.assert_allclose(
                g, w, rtol=MOMENT_RTOL,
                atol=MOMENT_RTOL * float(np.abs(w).max()),
                err_msg=f"{k} {leaf}")
    losses = results["train"][n][0][ARCHS[0]]["losses"]
    np.testing.assert_allclose(losses, want["losses"], rtol=LOSS_RTOL)


def test_checkpoint_from_4_ranks_restores_onto_3(results):
    for rep in results["restore"]:
        assert rep["step"] == CKPT_STEPS
        assert rep["restored_equal"]
        _assert_blocks(rep["local"], CKPT_TO)
        assert rep["params_equal"]
        assert rep["losses"][0] == rep["losses"][1]
        assert rep["opt_step"] == CKPT_STEPS + 1


if __name__ == "__main__":
    import torch
    torch.set_num_threads(1)
    mode, args = sys.argv[1], sys.argv[2:]
    {"train": train_main, "save": save_main, "restore": restore_main}[mode](
        int(args[0]), int(args[1]), args[2], args[3])
