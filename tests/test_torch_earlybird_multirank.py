"""Early-bird gradient sync of the port across two ranks.

Two ``gloo`` ranks run in subprocesses on the CPU (this file is also the
rank's program), each with half of a batch of the llama3.2-1b smoke
model.  As ``tests/multidev_scripts/check_earlybird.py`` asserts for the
JAX package:

  1. the bulk, per_leaf and partitioned modes give the full-batch
     single-process gradient (``rtol=2e-4, atol=2e-5``) and loss;
  2. the counts of issued all-reduces, one layer's counted once as in
     JAX's HLO, satisfy bulk < partitioned < per_leaf, and each equals the buckets of the JAX package's plan
     plus one for the loss;
  3. in partitioned mode every layer's reduction is issued before
     ``backward`` returns, last layer first -- the counterpart of JAX's
     all-reduces inside the backward scan -- and bulk issues none there.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
WORLD, B, S = 2, 4, 32
AGGR = 1 << 12
MODES = ("bulk", "per_leaf", "partitioned")
TIMEOUT_S = 120


def _model_and_batch():
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import pipeline
    from repro_torch.launch.steps import batch_to_device, build_state
    cfg = get_smoke_config("llama3.2-1b").replace(param_dtype="float32")
    return cfg, build_state, pipeline, batch_to_device


def rank_main(rank: int, store_path: str, out_dir: str) -> None:
    """One rank: its half of the batch through every sync mode."""
    import torch.distributed as dist
    from repro_torch.core.earlybird import (SyncConfig, SyncLog,
                                            make_layer_hook,
                                            value_and_synced_grad)
    from repro_torch.models import lm
    cfg, build_state, pipeline, to_dev = _model_and_batch()
    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    try:
        stream = pipeline.for_model(cfg, S, B, host_index=rank,
                                    host_count=WORLD)
        batch = to_dev(stream.batch(0), "cpu")
        result = {}
        for mode in MODES:
            model = build_state(cfg, 0, "cpu")["params"]
            sync = SyncConfig(mode=mode, aggr_bytes=AGGR)
            vg = value_and_synced_grad(
                lambda m, b, param_hook: lm.loss_fn(cfg, m, b,
                                                    param_hook=param_hook),
                sync)
            loss, grads = vg(model, batch)
            np.savez(os.path.join(out_dir, f"{mode}-{rank}.npz"),
                     **{k: g.numpy() for k, g in grads.items()})
            # what was issued before backward returned
            log = SyncLog()
            hook = make_layer_hook(sync, log)
            for p in model.parameters():
                p.grad = None
            lm.loss_fn(cfg, model, batch, param_hook=hook).backward()
            in_backward = [t for t, _ in log.entries]
            if hasattr(hook, "close"):
                assert hook.close() == []
            result[mode] = {"loss": float(loss),
                            "n_all_reduce": vg.log.count(),
                            "tags": [t for t, _ in vg.log.entries],
                            "in_backward": in_backward}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("earlybird")
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO / 'src'}{os.pathsep}" + env.get(
        "PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(out / "store"), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    res = [json.loads((out / f"rank{r}.json").read_text())
           for r in range(WORLD)]
    grads = {m: [dict(np.load(out / f"{m}-{r}.npz")) for r in range(WORLD)]
             for m in MODES}
    return res, grads


@pytest.fixture(scope="module")
def reference():
    """Full-batch gradients and loss in one process, no sync."""
    from repro_torch.models import lm
    cfg, build_state, pipeline, to_dev = _model_and_batch()
    model = build_state(cfg, 0, "cpu")["params"]
    batch = to_dev(pipeline.for_model(cfg, S, B).batch(0), "cpu")
    loss = lm.loss_fn(cfg, model, batch)
    loss.backward()
    return loss.item(), {n: p.grad.numpy() for n, p in
                         model.named_parameters()}


@pytest.mark.parametrize("mode", MODES)
def test_modes_give_the_full_batch_gradient(ranks, reference, mode):
    res, grads = ranks
    ref_loss, ref_grads = reference
    for r in range(WORLD):
        np.testing.assert_allclose(res[r][mode]["loss"], ref_loss,
                                   rtol=1e-5)
        assert grads[mode][r].keys() == ref_grads.keys()
        for name, want in ref_grads.items():
            np.testing.assert_allclose(grads[mode][r][name], want,
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"{mode} rank {r}: {name}")
    # every rank applies the same synced gradient
    for name in ref_grads:
        np.testing.assert_array_equal(grads[mode][0][name],
                                      grads[mode][1][name])


def test_all_reduce_counts(ranks):
    """The ordering that ``check_earlybird.py`` asserts on the JAX
    package's HLO, where the layer scan's body, and so one layer's
    collectives, appears once: here one layer's reductions count, the
    other layers' repeat them."""
    res, _ = ranks
    n = {m: sum(not t.startswith("layer ") or t == "layer 0"
                for t in res[0][m]["tags"]) for m in MODES}
    assert n["bulk"] < n["partitioned"] < n["per_leaf"], n
    for m in MODES:  # both ranks issue the same collectives in order
        assert res[0][m]["tags"] == res[1][m]["tags"]


def _reference_buckets(mode: str) -> int:
    """Buckets of the JAX package's plans for one step of ``mode`` on the
    smoke model's stacked f32 leaves: the whole tree at 256 MiB (bulk)
    or 0 (per_leaf); each layer's leaves at ``AGGR`` plus the rest at
    ``AGGR`` (partitioned)."""
    import dataclasses

    import jax
    from repro.configs import get_smoke_config
    from repro.core import bucketing as jb
    from repro.models import lm as jlm
    jcfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                               param_dtype="float32")
    shapes = jlm.param_shapes(jcfg)
    if mode != "partitioned":
        aggr = 256 << 20 if mode == "bulk" else 0
        return jb.make_plan(jax.tree.leaves(shapes), aggr).n_buckets
    layer = [jax.ShapeDtypeStruct(s.shape[1:], s.dtype)
             for s in jax.tree.leaves(shapes["layers"])]
    rest = [v for k, v in shapes.items() if k != "layers"]
    return (jcfg.n_layers * jb.make_plan(layer, AGGR).n_buckets
            + jb.make_plan(jax.tree.leaves(rest), AGGR).n_buckets)


@pytest.mark.parametrize("mode", MODES)
def test_all_reduce_counts_equal_reference_plan(ranks, mode):
    """Each mode issues one all-reduce per bucket of the reference plan,
    plus one for the loss: a stacked leaf is one collective, not one
    per layer."""
    res, _ = ranks
    want = _reference_buckets(mode) + 1
    for r in range(WORLD):
        assert res[r][mode]["n_all_reduce"] == want, (mode, r)


def test_partitioned_reduces_inside_backward(ranks):
    res, _ = ranks
    from repro_torch.configs import get_smoke_config
    n_layers = get_smoke_config("llama3.2-1b").n_layers
    for r in range(WORLD):
        inside = res[r]["partitioned"]["in_backward"]
        assert inside and all(t.startswith("layer ") for t in inside)
        layers = [int(t.split()[1]) for t in inside]
        # each layer's buckets together, the last layer's first
        firsts = list(dict.fromkeys(layers))
        assert firsts == list(range(n_layers - 1, -1, -1))
        assert layers == sorted(layers, reverse=True)
        tags = res[r]["partitioned"]["tags"]
        assert tags[:len(inside)] == inside
        assert set(tags[len(inside):]) == {"final", "loss"}
        assert res[r]["bulk"]["in_backward"] == []
        assert res[r]["per_leaf"]["in_backward"] == []


if __name__ == "__main__":
    torch.set_num_threads(1)
    rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
