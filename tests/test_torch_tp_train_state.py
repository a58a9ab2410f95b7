"""The tensor-parallel training state on ``gloo`` ranks in subprocesses
(this file is also the program of its ranks): ZeRO-1 over every axis,
the clip norm, checkpoints of the tensor-parallel shards and the
training CLI with ``--tp 2``.

On a (data 2, model 2) mesh, the llama3.2-1b smoke config (which M = 2
does not pad) in f32, two rows of each data shard, 24 tokens:

  * every AdamW moment is a DTensor of the whole leaf placed by
    ``launch.steps.opt_specs`` (``optim.adamw.opt_state_specs``: the
    parameter's spec, the data axes on its first free dim), each rank
    holding only its (model, data) block;
  * the clip norm of the step-0 gradients from the ranks' blocks
    (``adamw.global_norm`` summing the split leaves' squares over
    ``model``) equals the unsharded step's within ``NORM_RTOL``;
  * a checkpoint saved after 2 steps (the leaves assembled from the
    blocks, rank 0 writing) restores on the same mesh (parameters by
    ``param_shardings``, moments by ``opt_shardings``) and its third
    step is bitwise the uninterrupted run's (loss, parameters, moments);
  * restored on one rank at M = 1 (a (1, 1) mesh, the whole batch on
    it), its third loss is within ``LOSS_RTOL`` of the uninterrupted
    run's;
  * hymba-1.5b's checkpoint at M = 2 (5 heads padded to 6) restored at
    M = 1 raises ``restore``'s shape-mismatch ``ValueError``;
  * on that (1, 1) mesh the TP step of each of the ten smoke configs is
    bitwise the unsharded step: three steps' losses and gradients and
    the final parameters;
  * on a (1, 3) mesh (the FFN's 128 units in blocks of 43, 43 and 42,
    heads and vocabulary padded) the same round trip is bitwise.

The CLI: two ranks run ``python -m repro_torch.launch.train --smoke
--device cpu --tp 2 --steps 4 --ckpt-every 2`` (its group the test's);
a copy of its checkpoint directory holding only the step-2 checkpoint
(what a run stopped after it leaves) is resumed with the same flags and
``--resume``: its first two losses equal the uninterrupted run's last
two, and its step-4 checkpoint equals the uninterrupted one's, leaf for
leaf, bit for bit.
"""

import contextlib
import io
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from _ranks import finish, gloo_rank, spawn

ARCH = "llama3.2-1b"
PADDED = "hymba-1.5b"
ARCHS_ONE = ("llama3.2-1b", "gemma2-9b", "qwen2-7b", "qwen2-vl-7b",
             "musicgen-medium", "granite-moe-3b-a800m",
             "moonshot-v1-16b-a3b", "minicpm3-4b", "mamba2-780m",
             "hymba-1.5b")
ROWS, S, DP, M = 2, 24, 2, 2
NORM_RTOL = 1e-6
LOSS_RTOL = 1e-5
CLI_STEPS = 4
TIMEOUT_S = 180


def port_config(arch):
    from repro_torch.configs import get_smoke_config
    return get_smoke_config(arch).replace(param_dtype="float32")


def scfg():
    from repro_torch.launch.steps import StepConfig
    return StepConfig(sync_mode="partitioned", aggr_bytes=1 << 12,
                      param_dtype="float32", peak_lr=1e-3, warmup_steps=1,
                      total_steps=10)


def batches(cfg, index: int, count: int, first: int, n: int):
    from repro_torch.data import pipeline
    from repro_torch.launch.steps import batch_to_device
    stream = pipeline.for_model(cfg, S, ROWS * DP, host_index=index,
                                host_count=count)
    return [batch_to_device(stream.batch(i), "cpu")
            for i in range(first, first + n)]


def _dump(path, tree):
    from repro_torch.models import convert
    np.savez(path, **convert.jax_to_leaves(tree))


def _restore_state(cfg, mesh, ckpt):
    """A checkpoint restored onto ``mesh``: parameters and moments
    placed by its shardings, this rank's blocks kept."""
    from repro_torch.ckpt import checkpoint as pckpt
    from repro_torch.launch import steps
    from repro_torch.models import convert
    template = convert.state_to_jax(steps.build_state(cfg, 1, "cpu",
                                                      mesh=mesh))
    step, tree = pckpt.restore(ckpt, template, shardings={
        "params": steps.param_shardings(cfg, mesh),
        "opt": steps.opt_shardings(cfg, mesh)})
    return step, convert.state_from_jax(tree, cfg, device="cpu", mesh=mesh)


def _round_trip(mesh, cfg, state, step, batch, out, tag, rank):
    """Save ``state`` (after 2 steps) as ``ckpt-<tag>``, take a third
    step, restore the checkpoint on the same mesh and take the third
    step again; rank 0 writes both resulting states (``<tag>-whole``,
    ``<tag>-again``).  Returns the third loss and the resumed run's."""
    from repro_torch.ckpt import checkpoint as pckpt
    from repro_torch.launch import steps
    from repro_torch.models import convert
    tree = convert.state_to_jax(state)
    if rank == 0:
        pckpt.save(out / f"ckpt-{tag}", 2, tree)
    state, loss = step(state, batch)
    whole = convert.state_to_jax(state)
    at, resumed = _restore_state(cfg, mesh, out / f"ckpt-{tag}")
    rstep = steps.make_train_step(cfg, scfg(), seq_len=S,
                                  batch=batch["tokens"].shape[0]
                                  * mesh.shape[0], device="cpu", mesh=mesh)
    resumed, again_loss = rstep(resumed, batch)
    again = convert.state_to_jax(resumed)
    if rank == 0:
        _dump(out / f"{tag}-whole.npz", whole)
        _dump(out / f"{tag}-again.npz", again)
    return float(loss), {"step": at, "loss": float(again_loss),
                         "opt_step": int(resumed["opt"]["step"])}


def three_main(rank: int, n: int, store_path: str, out_dir: str) -> None:
    """The round trip on a (1, 3) mesh, whose blocks are uneven: M = 3
    pads the heads (4 to 6) and the vocabulary (128 to 129) and splits
    the FFN's 128 units 43/43/42."""
    import torch
    from repro_torch.launch import mesh as pmesh
    from repro_torch.launch import steps
    torch.set_num_threads(1)
    dist = gloo_rank(rank, n, store_path)
    out, report = Path(out_dir), {}
    try:
        mesh = pmesh.make_mesh((1, 3), ("data", "model"), "cpu")
        cfg = port_config(ARCH)
        data = batches(cfg, 0, 1, 0, 3)
        state = steps.build_state(cfg, 0, "cpu", mesh=mesh)
        step = steps.make_train_step(cfg, scfg(), seq_len=S,
                                     batch=ROWS * DP, device="cpu",
                                     mesh=mesh)
        losses = []
        for b in data[:2]:
            state, loss = step(state, b)
            losses.append(float(loss))
        loss, report["resumed"] = _round_trip(mesh, cfg, state, step,
                                              data[2], out, "m3", rank)
        report["losses"] = losses + [loss]
        report["ffn"] = list(state["params"].layers[0].mlp.w_up.shape)
    finally:
        (out / f"three-{rank}.json").write_text(json.dumps(report))
        dist.destroy_process_group()


def state_main(rank: int, n: int, store_path: str, out_dir: str) -> None:
    """ZeRO-1, the clip norm and the checkpoint round trip on (2, 2)."""
    import torch
    from repro_torch.launch import mesh as pmesh
    from repro_torch.launch import steps
    from repro_torch.models import convert, lm
    from repro_torch.optim import adamw
    torch.set_num_threads(1)
    dist = gloo_rank(rank, n, store_path)
    out, report = Path(out_dir), {}
    try:
        mesh = pmesh.make_mesh((DP, M), ("data", "model"), "cpu")
        di = pmesh.axis_index(mesh, pmesh.dp_axes(mesh))
        cfg = port_config(ARCH)
        cfg_tp = cfg.with_tp(M)
        data = batches(cfg, di, DP, 0, 3)
        state = steps.build_state(cfg, 0, "cpu", mesh=mesh)
        specs = steps.opt_specs(cfg, mesh)["m"]
        shapes = lm.param_shapes(cfg_tp)
        units = lm.param_units(cfg_tp)
        report["placed"] = all(
            list(t.placements) == pmesh.to_placements(specs[k], mesh, t.dim())
            and tuple(t.shape) == tuple(shapes[k])
            and tuple(t.to_local().shape) == tuple(
                s.stop - s.start for s in pmesh.local_slices(
                    shapes[k], specs[k], mesh, units[k]))
            for key in ("m", "v") for k, t in state["opt"][key].items())
        report["split_both"] = sorted(
            k for k, s in specs.items()
            if "model" in tuple(s) and "data" in tuple(s))
        step = steps.make_train_step(cfg, scfg(), seq_len=S,
                                     batch=ROWS * DP, device="cpu",
                                     mesh=mesh)
        losses = []
        for i, b in enumerate(data[:2]):
            state, loss = step(state, b)
            losses.append(float(loss))
            if i == 0:
                grads = {k: p.grad for k, p in
                         state["params"].named_parameters()}
                split = {k for k in grads
                         if "model" in tuple(specs[adamw._leaf_name(k)])}
                report["norm"] = float(adamw.global_norm(
                    grads, split, pmesh.axis_group(mesh, "model")))
        # the unsharded step-0 norm on the same rows, synced over data
        plain = steps.build_state(cfg_tp, 0, "cpu")
        ustep = steps.make_train_step(
            cfg_tp, scfg(), seq_len=S, batch=ROWS, device="cpu",
            group=pmesh.axis_group(mesh, pmesh.dp_axes(mesh)))
        plain, _ = ustep(plain, data[0])
        report["plain_norm"] = float(adamw.global_norm(
            {k: p.grad for k, p in plain["params"].named_parameters()}))
        del plain
        loss, report["resumed"] = _round_trip(mesh, cfg, state, step,
                                              data[2], out, "m2", rank)
        report["losses"] = losses + [loss]
        # a model that M = 2 pads (hymba-1.5b: 5 heads to 6)
        tree = convert.state_to_jax(steps.build_state(
            port_config(PADDED), 0, "cpu", mesh=mesh))
        if rank == 0:
            from repro_torch.ckpt import checkpoint as pckpt
            pckpt.save(out / "ckpt-padded", 0, tree)
    finally:
        (out / f"state-{rank}.json").write_text(json.dumps(report))
        dist.destroy_process_group()


def _one_rank_bitwise(torch, steps, mesh, arch) -> dict:
    """Three TP steps on a (1, 1) mesh against three unsharded steps
    from the same seed on the same batches: whether every loss, every
    step's every gradient and the final parameters are equal bit for
    bit."""
    from repro_torch.data import pipeline
    cfg = port_config(arch)
    s = 96 if cfg.frontend == "vision_stub" else S
    stream = pipeline.for_model(cfg, s, ROWS)
    data = []
    for i in range(3):
        b = steps.batch_to_device(stream.batch(i), "cpu")
        if cfg.mrope_sections is not None:
            b["positions"] = torch.from_numpy(
                pipeline.grid_positions(ROWS, s, 1, 8, 8))
        data.append(b)
    runs = []
    for m in (None, mesh):
        state = steps.build_state(cfg, 0, "cpu", mesh=m)
        step = steps.make_train_step(cfg, scfg(), seq_len=s, batch=ROWS,
                                     device="cpu", mesh=m)
        losses, grads = [], []
        for b in data:
            state, loss = step(state, b)
            losses.append(float(loss))
            grads.append({k: p.grad.clone() for k, p in
                          state["params"].named_parameters()})
        runs.append((losses, grads, dict(state["params"]
                                         .named_parameters())))
    (lu, gu, pu), (lt, gt, pt) = runs
    return {"losses": lu == lt,
            "grads": all(torch.equal(a[k], b[k]) for a, b in zip(gu, gt)
                         for k in a),
            "params": all(torch.equal(p, pt[k]) for k, p in pu.items())}


def one_main(rank: int, n: int, store_path: str, out_dir: str) -> None:
    """The M = 2 checkpoints restored on one rank at M = 1."""
    import torch
    from repro_torch.launch import mesh as pmesh
    from repro_torch.launch import steps
    torch.set_num_threads(1)
    dist = gloo_rank(rank, n, store_path)
    out, report = Path(out_dir), {}
    try:
        mesh = pmesh.make_mesh((1, 1), ("data", "model"), "cpu")
        cfg = port_config(ARCH)
        at, state = _restore_state(cfg, mesh, out / "ckpt-m2")
        step = steps.make_train_step(cfg, scfg(), seq_len=S,
                                     batch=ROWS * DP, device="cpu",
                                     mesh=mesh)
        b, = batches(cfg, 0, 1, 2, 1)
        state, loss = step(state, b)
        report["step"], report["loss"] = at, float(loss)
        try:
            _restore_state(port_config(PADDED), mesh, out / "ckpt-padded")
            report["padded"] = "no error"
        except ValueError as e:
            report["padded"] = str(e)
        report["bitwise"] = {arch: _one_rank_bitwise(torch, steps, mesh,
                                                     arch)
                             for arch in ARCHS_ONE}
    finally:
        (out / f"one-{rank}.json").write_text(json.dumps(report))
        dist.destroy_process_group()


def cli_main(rank: int, n: int, store_path: str, out_dir: str,
             run: str) -> None:
    """``launch.train`` with ``--tp 2`` on the test's two-rank group;
    ``run`` ``B`` resumes."""
    import torch
    from repro_torch.launch import train
    torch.set_num_threads(1)
    dist = gloo_rank(rank, n, store_path)
    buf = io.StringIO()
    try:
        argv = ["--smoke", "--device", "cpu", "--tp", "2", "--steps",
                str(CLI_STEPS), "--ckpt-every", "2", "--seq-len", "24",
                "--ckpt-dir", os.path.join(out_dir, f"cli{run}")]
        if run == "B":
            argv.append("--resume")
        with contextlib.redirect_stdout(buf):
            rc = train.main(argv)
    finally:
        text = buf.getvalue()
        Path(out_dir, f"cli{run}-{rank}.txt").write_text(
            f"{text}\nrc={locals().get('rc')}")
        dist.destroy_process_group()


CKPT = "llama3.2-1b-smoke"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_state")
    procs = [spawn(__file__, "state", r, DP * M, out / "store-state", out)
             for r in range(DP * M)]
    procs += [spawn(__file__, "cli", r, 2, out / "store-cliA", out, "A")
              for r in range(2)]
    finish(procs, TIMEOUT_S)
    # what a run stopped after its step-2 checkpoint leaves behind
    src, dst = out / "cliA" / CKPT, out / "cliB" / CKPT
    dst.mkdir(parents=True)
    shutil.copytree(src / "step_00000002", dst / "step_00000002")
    (dst / "LATEST").write_text("step_00000002")
    procs = [spawn(__file__, "one", 0, 1, out / "store-one", out)]
    procs += [spawn(__file__, "three", r, 3, out / "store-three", out)
              for r in range(3)]
    procs += [spawn(__file__, "cli", r, 2, out / "store-cliB", out, "B")
              for r in range(2)]
    finish(procs, TIMEOUT_S)

    def load(name):
        return json.loads((out / name).read_text())
    return {"state": [load(f"state-{r}.json") for r in range(DP * M)],
            "three": [load(f"three-{r}.json") for r in range(3)],
            "one": load("one-0.json"), "out": out}


def test_moments_are_placed_by_the_specs_over_every_axis(results):
    for rep in results["state"]:
        assert rep["placed"]
        assert {"embed", "layers.attn.wq", "layers.mlp.w_up"} <= \
            set(rep["split_both"])


def test_clip_norm_equals_the_unsharded_steps(results):
    for rep in results["state"]:
        np.testing.assert_allclose(rep["norm"], rep["plain_norm"],
                                   rtol=NORM_RTOL)
    norms = {rep["norm"] for rep in results["state"]}
    assert len(norms) == 1


@pytest.mark.parametrize("tag", ["m2", "m3"])
def test_checkpoint_restores_on_the_same_mesh_bitwise(results, tag):
    """On (2, 2), and on (1, 3), whose blocks of the FFN are uneven."""
    out = results["out"]
    for rep in results["state" if tag == "m2" else "three"]:
        assert rep["resumed"]["step"] == 2
        assert rep["resumed"]["opt_step"] == 3
        assert rep["resumed"]["loss"] == rep["losses"][2]
    if tag == "m3":
        assert [r["ffn"][1] for r in results["three"]] == [43, 43, 42]
    whole = np.load(out / f"{tag}-whole.npz")
    again = np.load(out / f"{tag}-again.npz")
    assert set(whole.files) == set(again.files)
    assert any(k.startswith("opt.m.") for k in whole.files)
    for k in whole.files:
        np.testing.assert_array_equal(again[k], whole[k], err_msg=k)


def test_checkpoint_restores_at_one_model_rank(results):
    one, state = results["one"], results["state"][0]
    assert one["step"] == 2
    np.testing.assert_allclose(one["loss"], state["losses"][2],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ARCHS_ONE)
def test_one_model_rank_is_the_unsharded_step_bitwise(results, arch):
    """On a (1, 1) mesh the TP step (the masked embedding lookup, the
    one-rank collectives, the unsharded cross entropy, ZeRO-1) gives
    the unsharded step's losses, gradients at every step and
    parameters, bit for bit."""
    assert results["one"]["bitwise"][arch] == {
        "losses": True, "grads": True, "params": True}


def test_checkpoint_of_other_padding_is_refused(results):
    assert "shape mismatch" in results["one"]["padded"]


def _cli_losses(out, run, rank):
    text = (out / f"cli{run}-{rank}.txt").read_text()
    assert text.rstrip().endswith("rc=0"), text[-2000:]
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]), text


@pytest.mark.parametrize("rank", [0, 1])
def test_cli_trains_with_tp_2_and_resumes_exactly(results, rank):
    out = results["out"]
    a, text_a = _cli_losses(out, "A", rank)
    b, text_b = _cli_losses(out, "B", rank)
    assert "mesh: data=1 model=2" in text_a
    assert a["world"] == 2 and a["steps"] == CLI_STEPS
    assert "resumed from step 2" in text_b
    assert b["losses"][:2] == a["losses"][2:]
    if rank == 0:
        from repro_torch.ckpt import checkpoint as pckpt
        _, want = pckpt.restore(out / "cliA" / CKPT, _template(out, "A"),
                                step=4)
        _, got = pckpt.restore(out / "cliB" / CKPT, _template(out, "B"),
                               step=4)
        from repro_torch.models import convert
        flat_w, flat_g = (convert.jax_to_leaves(t) for t in (want, got))
        assert set(flat_w) == set(flat_g)
        for k in flat_w:
            np.testing.assert_array_equal(flat_g[k], flat_w[k], err_msg=k)


def _template(out, run):
    """A template tree of the saved checkpoint's own leaf shapes."""
    meta = json.loads((out / f"cli{run}" / CKPT / "step_00000004"
                       / "meta.json").read_text())
    tree = {}
    for leaf in meta["leaves"]:
        keys = [k.strip("'") for k in leaf["path"][1:-1].split("][")]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.zeros(leaf["shape"], np.float32)
    return tree


if __name__ == "__main__":
    mode, args = sys.argv[1], sys.argv[2:]
    fn = {"state": state_main, "one": one_main, "three": three_main,
          "cli": cli_main}[mode]
    fn(int(args[0]), int(args[1]), *args[2:])
