"""The port's training path against the JAX package's.

On the llama3.2-1b smoke config in f32, with the JAX package's
``init_params(PRNGKey(0))`` carried across (``convert.params_from_jax``)
and the same batches, the port's training must meet JAX's within the
tolerances of ``tests/multidev_scripts/check_earlybird.py``: the step-0
synced gradients within ``rtol=2e-4, atol=2e-5`` of JAX's
single-program gradients, and the losses of three steps through
``make_train_step`` within ``rtol=1e-5`` of JAX's ``make_train_step`` on
a one-device mesh (as ``examples/quickstart.py`` runs it), in each of the
three sync modes.  On the CPU the bucket kernels run their plain
versions; the sync runs over a one-rank ``gloo`` group.  Also: the data
stream, the schedule and AdamW against JAX, the chunked cross entropy,
checkpoints across the two packages, exact resume, and the
``python -m repro_torch.launch.train`` command line.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.ckpt import checkpoint as jckpt
from repro.compat import set_mesh
from repro.configs import get_smoke_config as jsmoke
from repro.core import recovery as jrecovery
from repro.data import pipeline as jpipe
from repro.launch import steps as jsteps
from repro.launch.train import build_state as jbuild_state
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.runtime import elastic
from repro_torch.ckpt import checkpoint as pckpt
from repro_torch.configs import get_smoke_config as psmoke
from repro_torch.core.earlybird import SyncConfig, value_and_synced_grad
from repro_torch.data import pipeline as ppipe
from repro_torch.launch import steps as psteps
from repro_torch.launch import train as ptrain
from repro_torch.models import convert, layers as players, lm as plm
from repro_torch.optim import adamw as padamw
from repro_torch.optim import schedule as pschedule
from repro_torch.runtime import fault_tolerance as pft

MODES = ("bulk", "per_leaf", "partitioned")
B, S, STEPS = 2, 32, 3
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)   # check_earlybird.py
LOSS_RTOL = 1e-5
AGGR = 1 << 12  # small buckets: the smoke layers split into several


@pytest.fixture(scope="module", autouse=True)
def group(tmp_path_factory):
    """A one-rank gloo group for the module (the sync's all-reduces)."""
    if dist.is_initialized():
        yield
        return
    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def setup():
    jc = jsmoke("llama3.2-1b").replace(param_dtype="float32")
    pc = psmoke("llama3.2-1b").replace(param_dtype="float32")
    params = jlm.init_params(jc, jax.random.PRNGKey(0))
    stream = jpipe.for_model(jc, S, B)
    batches = [stream.batch(i) for i in range(STEPS + 1)]
    return jc, pc, params, batches


def _scfg_pair(mode):
    kw = dict(sync_mode=mode, aggr_bytes=AGGR, param_dtype="float32",
              peak_lr=1e-3, warmup_steps=1, total_steps=10)
    return jsteps.StepConfig(**kw), psteps.StepConfig(**kw)


def _port_state(pc, params):
    np_params = jax.tree.map(np.asarray, params)
    opt = jax.tree.map(np.asarray, jadamw.init_opt_state(
        params, jadamw.AdamWConfig()))
    return convert.state_from_jax({"params": np_params, "opt": opt}, pc,
                                  device="cpu")


@pytest.fixture(scope="module")
def jax_losses(setup):
    """JAX's make_train_step on a one-device mesh: 3 losses per mode."""
    jc, _, _, batches = setup
    mesh = elastic.build_mesh(elastic.plan_mesh(1, 1))
    out = {}
    for mode in MODES:
        scfg, _ = _scfg_pair(mode)
        with set_mesh(mesh):
            step_fn, *_ = jsteps.make_train_step(jc, mesh, scfg, seq_len=S,
                                                 global_batch=B)
            step = jax.jit(step_fn)
            state = jbuild_state(jc, mesh, scfg)
            losses = []
            for b in batches[:STEPS]:
                state, loss = step(state, {k: jnp.asarray(v)
                                           for k, v in b.items()})
                losses.append(float(loss))
        out[mode] = losses
    return out


# ---------------------------------------------------------------------------
# data, schedule, optimizer, loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("host_count", [1, 2])
def test_data_batches_equal_jax(host_count):
    jc, pc = jsmoke("llama3.2-1b"), psmoke("llama3.2-1b")
    for h in range(host_count):
        js = jpipe.for_model(jc, 64, 4, seed=3, host_index=h,
                             host_count=host_count)
        ps = ppipe.for_model(pc, 64, 4, seed=3, host_index=h,
                             host_count=host_count)
        for step in (0, 1, 7):
            a, b = js.batch(step), ps.batch(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_schedule_matches_jax():
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        want = float(jschedule.warmup_cosine(step, **kw))
        got = float(pschedule.warmup_cosine(torch.tensor(step,
                                                         dtype=torch.int32),
                                            **kw))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert float(pschedule.warmup_cosine(0, **kw)) == 0.0


@pytest.mark.parametrize("clip", [1.0, 0.0, 1e-3])
def test_adamw_update_matches_jax(clip):
    rng = np.random.default_rng(4)
    shapes = {"a": (7, 5), "b": (13,), "c": (2, 3, 4)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) * 0.3
              for k, s in shapes.items()} for _ in range(3)]
    cfg_j = jadamw.AdamWConfig(clip_norm=clip)
    cfg_p = padamw.AdamWConfig(clip_norm=clip)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    js = jadamw.init_opt_state(jp, cfg_j)
    pp = {k: torch.tensor(v) for k, v in p.items()}
    ps = padamw.init_opt_state(pp, cfg_p)
    for g in grads:
        jp, js = jadamw.adamw_update(jp, {k: jnp.asarray(v)
                                          for k, v in g.items()}, js, 1e-2,
                                     cfg_j)
        padamw.adamw_update(pp, {k: torch.tensor(v) for k, v in g.items()},
                            ps, torch.tensor(1e-2), cfg_p)
    assert int(ps["step"]) == int(js["step"]) == 3
    for k in shapes:
        for got, want in ((pp[k], jp[k]), (ps["m"][k], js["m"][k]),
                          (ps["v"][k], js["v"][k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        float(padamw.global_norm({k: torch.tensor(v)
                                  for k, v in grads[0].items()})),
        float(jadamw.global_norm({k: jnp.asarray(v)
                                  for k, v in grads[0].items()})),
        rtol=1e-6)


@pytest.mark.parametrize("valid_vocab,gather", [(None, False), (45, False),
                                                (None, True)])
def test_chunked_cross_entropy_matches_jax(valid_vocab, gather):
    """Value and gradient; 40 tokens in chunks of 16 leave a remainder."""
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 40, 16)).astype(np.float32)
    head = rng.standard_normal((16, 50)).astype(np.float32)
    y = rng.integers(0, 45, (2, 40))
    mask = (rng.random((2, 40)) < 0.8).astype(np.float32)
    kw = dict(chunk=16, valid_vocab=valid_vocab, gather_targets=gather)

    def jloss(hh, hd):
        return jlayers.chunked_cross_entropy(hh, hd, jnp.asarray(y, jnp.int32),
                                             mask=jnp.asarray(mask), **kw)
    want, (gh, ghead) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(h), jnp.asarray(head))
    th = torch.tensor(h, requires_grad=True)
    thead = torch.tensor(head, requires_grad=True)
    got = players.chunked_cross_entropy(th, thead, torch.tensor(y),
                                        mask=torch.tensor(mask), **kw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(thead.grad.numpy(), np.asarray(ghead),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_fn_matches_jax(setup, remat):
    jc, pc, params, batches = setup
    b = batches[0]
    want = jlm.loss_fn(jc, params, {k: jnp.asarray(v) for k, v in b.items()},
                       remat=remat)
    model = convert.params_from_jax(jax.tree.map(np.asarray, params), pc,
                                    device="cpu")
    calls = []
    got = plm.loss_fn(pc, model, psteps.batch_to_device(b, "cpu"),
                      remat=remat, param_hook=lambda lp: calls.append(lp)
                      or lp)
    assert calls == list(model.layers)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# the training step against JAX, in every sync mode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_grads(setup):
    """JAX's single-program loss and gradients on batch 0."""
    jc, _, params, batches = setup
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    return jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jc, p, b)))(params, jb)


@pytest.mark.parametrize("mode", MODES)
def test_step0_synced_grads_match_jax(setup, jax_grads, mode):
    jc, pc, params, batches = setup
    want_loss, want = jax_grads
    state = _port_state(pc, params)
    vg = value_and_synced_grad(
        lambda m, b, param_hook: plm.loss_fn(pc, m, b, param_hook=param_hook),
        SyncConfig(mode=mode, aggr_bytes=AGGR))
    loss, grads = vg(state["params"], psteps.batch_to_device(batches[0],
                                                             "cpu"))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    got = convert.named_to_jax(grads)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(k) for k, _ in flat_w] == \
        [jax.tree_util.keystr(k) for k, _ in flat_g]
    for (kp, a), (_, g) in zip(flat_w, flat_g):
        np.testing.assert_allclose(g, np.asarray(a), **GRAD_TOL,
                                   err_msg=f"{mode}: {kp}")
    layer_tags = [t for t, _ in vg.log.entries if t.startswith("layer")]
    if mode == "partitioned":  # reduced in backward, last layer first
        order = [int(t.split()[1]) for t in layer_tags]
        assert order == sorted(order, reverse=True) and set(order) == {0, 1}
    else:
        assert not layer_tags


@pytest.mark.parametrize("mode", MODES)
def test_train_losses_match_jax(setup, jax_losses, mode):
    jc, pc, params, batches = setup
    _, scfg = _scfg_pair(mode)
    step = psteps.make_train_step(pc, scfg, seq_len=S, batch=B, device="cpu")
    state = _port_state(pc, params)
    losses = []
    for b in batches[:STEPS]:
        state, loss = step(state, psteps.batch_to_device(b, "cpu"))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jax_losses[mode], rtol=LOSS_RTOL)
    assert int(state["opt"]["step"]) == STEPS


def test_sync_modes_give_equal_grads_on_one_rank(setup):
    """One rank: the sync is exact, so the modes agree bit for bit."""
    _, pc, params, batches = setup
    out = {}
    for mode in MODES:
        state = _port_state(pc, params)
        vg = value_and_synced_grad(
            lambda m, b, param_hook: plm.loss_fn(pc, m, b,
                                                 param_hook=param_hook),
            SyncConfig(mode=mode, aggr_bytes=AGGR))
        loss, grads = vg(state["params"],
                         psteps.batch_to_device(batches[1], "cpu"))
        out[mode] = (loss, {k: g.clone() for k, g in grads.items()})
    for mode in ("bulk", "per_leaf"):
        assert torch.equal(out[mode][0], out["partitioned"][0])
        for k, g in out[mode][1].items():
            assert torch.equal(g, out["partitioned"][1][k]), (mode, k)


@pytest.mark.parametrize("mode", MODES)
def test_comm_dtype_rounds_the_wire(setup, mode):
    """comm_dtype='bfloat16': on one rank the synced gradient is the
    local gradient rounded to bf16 and back."""
    _, pc, params, batches = setup
    b = psteps.batch_to_device(batches[0], "cpu")
    out = {}
    for dt in (None, "bfloat16"):
        state = _port_state(pc, params)
        vg = value_and_synced_grad(
            lambda m, bb, param_hook: plm.loss_fn(pc, m, bb,
                                                  param_hook=param_hook),
            SyncConfig(mode=mode, aggr_bytes=AGGR, comm_dtype=dt))
        _, grads = vg(state["params"], b)
        out[dt] = grads
    for k, g in out["bfloat16"].items():
        assert g.dtype == torch.float32
        assert torch.equal(g, out[None][k].bfloat16().float()), k


def test_layer_hook_reports_a_layer_without_gradients(setup):
    _, pc, params, batches = setup
    state = _port_state(pc, params)

    def loss_fn(m, b, param_hook):  # layer 1 is hooked but never used
        for lp in m.layers:
            param_hook(lp)
        return sum(p.sum() for n, p in m.named_parameters()
                   if not n.startswith("layers.1."))
    vg = value_and_synced_grad(loss_fn, SyncConfig(mode="partitioned"))
    with pytest.raises(RuntimeError, match=r"layers \[1\]"):
        vg(state["params"], psteps.batch_to_device(batches[0], "cpu"))


@pytest.mark.parametrize("mode", ["bulk", "per_leaf"])
def test_stacked_sync_reports_a_parameter_without_gradient(setup, mode):
    """In bulk and per_leaf mode the stacked leaves' gradients are
    gathered into one buffer, and a layer parameter that backward never
    reaches is still reported, not synced as zeros."""
    _, pc, params, batches = setup
    state = _port_state(pc, params)

    def loss_fn(m, b, param_hook):  # layer 1 is never used
        return sum(p.sum() for n, p in m.named_parameters()
                   if not n.startswith("layers.1."))
    vg = value_and_synced_grad(loss_fn, SyncConfig(mode=mode))
    with pytest.raises(RuntimeError, match=r"layers\.1\..* got no"):
        vg(state["params"], psteps.batch_to_device(batches[0], "cpu"))


# ---------------------------------------------------------------------------
# checkpoints and resume
# ---------------------------------------------------------------------------

def test_jax_checkpoint_restores_in_port(setup, tmp_path):
    jc, pc, params, _ = setup
    opt = jadamw.init_opt_state(params, jadamw.AdamWConfig())
    jtree = {"params": params, "opt": opt}
    jckpt.save(tmp_path, 5, jtree)
    template = convert.state_to_jax(_port_state(pc, params))
    step, tree = pckpt.restore(tmp_path, template)
    assert step == 5 == pckpt.latest_step(tmp_path)
    state = convert.state_from_jax(tree, pc, device="cpu")
    want = convert.params_from_jax(jax.tree.map(np.asarray, params), pc,
                                   device="cpu")
    for (n, a), (_, b) in zip(state["params"].named_parameters(),
                              want.named_parameters()):
        assert torch.equal(a, b), n
    # and the port's checkpoint restores in JAX, path for path
    pckpt.save(tmp_path / "port", 6, convert.state_to_jax(state))
    step, back = jckpt.restore(tmp_path / "port", jtree)
    assert step == 6
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_detects_corruption(tmp_path):
    tree = {"a": np.arange(6, dtype=np.float32), "b": {"c": np.ones(3)}}
    pckpt.save(tmp_path, 1, tree)
    step, back = pckpt.restore(tmp_path, tree)
    np.testing.assert_array_equal(back["b"]["c"], tree["b"]["c"])
    np.save(tmp_path / "step_00000001" / "leaf_00000.npy",
            np.zeros(6, np.float32))
    with pytest.raises(IOError, match="checksum"):
        pckpt.restore(tmp_path, tree)


def _run(pc, scfg, state, batches, start, n, ckpt):
    step = psteps.make_train_step(pc, scfg, seq_len=S, batch=B, device="cpu")
    return pft.run_training_loop(
        step_fn=step, state=state, start_step=start, num_steps=n,
        checkpoint_every=2, checkpointer=ckpt,
        get_batch=lambda i: psteps.batch_to_device(batches[i], "cpu"))


def test_resume_is_exact(setup, tmp_path):
    """4 steps == 2 steps, save, restore, 2 more steps: bitwise."""
    _, pc, params, batches = setup
    _, scfg = _scfg_pair("partitioned")
    whole = _port_state(pc, params)
    r = _run(pc, scfg, whole, batches, 0, 4,
             pckpt.AsyncCheckpointer(tmp_path / "a",
                                     to_tree=convert.state_to_jax))
    assert r.final_step == 4
    half = _port_state(pc, params)
    _run(pc, scfg, half, batches, 0, 2,
         pckpt.AsyncCheckpointer(tmp_path / "b",
                                 to_tree=convert.state_to_jax))
    start, tree = pckpt.restore(tmp_path / "b", convert.state_to_jax(half))
    assert start == 2
    resumed = convert.state_from_jax(tree, pc, device="cpu")
    r2 = _run(pc, scfg, resumed, batches, 2, 2,
              pckpt.AsyncCheckpointer(tmp_path / "b",
                                      to_tree=convert.state_to_jax))
    assert r2.losses == r.losses[2:]
    for (n, a), (_, b) in zip(whole["params"].named_parameters(),
                              resumed["params"].named_parameters()):
        assert torch.equal(a, b), n
    for key in ("m", "v"):
        for n, a in whole["opt"][key].items():
            assert torch.equal(a, resumed["opt"][key][n]), (key, n)
    assert int(whole["opt"]["step"]) == int(resumed["opt"]["step"]) == 4


def test_retry_constants_match_jax():
    assert pft.DEFAULT_TIMEOUT_US == jrecovery.DEFAULT_TIMEOUT_US
    assert pft.DEFAULT_BACKOFF == jrecovery.DEFAULT_BACKOFF
    assert pft.DEFAULT_MAX_RETRIES == jrecovery.DEFAULT_MAX_RETRIES


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

def test_train_cli_runs_on_cpu(tmp_path, capsys):
    rc = ptrain.main(["--smoke", "--device", "cpu", "--steps", "3",
                      "--seq-len", "32", "--log-every", "1", "--ckpt-dir",
                      str(tmp_path), "--ckpt-every", "2"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith("done: 3 steps") for line in out)
    rec = json.loads(out[-1])
    assert rec["steps"] == 3 and rec["world"] == 1 and rec["kind"] == "cpu"
    assert all(np.isfinite(rec["losses"]))
    assert pckpt.latest_step(tmp_path / "llama3.2-1b-smoke") == 3
    # --resume continues from the checkpoint
    rc = ptrain.main(["--smoke", "--device", "cpu", "--steps", "1",
                      "--seq-len", "32", "--ckpt-dir", str(tmp_path),
                      "--resume"])
    assert rc == 0
    assert "resumed from step 3" in capsys.readouterr().out


def test_train_cli_rejects_tensor_parallel(capsys):
    """One process with ``--tp 2`` raises ``plan_mesh``'s error, as the
    JAX package's CLI does (``--tp 2`` trains on two ranks:
    ``tests/test_torch_tp_train_state.py``)."""
    with pytest.raises(ValueError, match="cannot keep model parallelism 2"):
        ptrain.main(["--smoke", "--device", "cpu", "--tp", "2"])
