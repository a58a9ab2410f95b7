"""Three training steps of every architecture on the port against the
JAX package's ``make_train_step``.

For each of the ten smoke configs in f32, the JAX package's
``init_params(PRNGKey(0))`` (with zero AdamW moments) is carried across,
and three batches of the data stream (qwen2-vl at S 96 with explicit
M-RoPE grid positions in both packages, as
``test_torch_train_families.py`` builds them) go through the port's
``make_train_step`` on a one-rank gloo group and through JAX's on a
one-device mesh, in each sync mode: the losses must agree within
``rtol=1e-5``.  musicgen's ``embed``, which gets a zero gradient in both
packages, must also end the three steps as JAX's does (weight decay and
nothing else).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.compat import set_mesh
from repro.launch import steps as jsteps
from repro.launch.train import build_state as jbuild_state
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.runtime import elastic
from repro_torch.configs import get_smoke_config as psmoke
from repro_torch.launch import steps as psteps
from repro_torch.models import convert

from _torch_models import gloo_group, seq_len, stream_batches  # noqa: F401

ARCHS = sorted(jconfigs.ARCH_IDS)
MODES = ("bulk", "per_leaf", "partitioned")
B, STEPS = 2, 3
LOSS_RTOL = 1e-5
AGGR = 1 << 12


def _scfg_pair(mode):
    kw = dict(sync_mode=mode, aggr_bytes=AGGR, param_dtype="float32",
              peak_lr=1e-3, warmup_steps=1, total_steps=10)
    return jsteps.StepConfig(**kw), psteps.StepConfig(**kw)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jc = jconfigs.get_smoke_config(arch).replace(param_dtype="float32")
    pc = psmoke(arch).replace(param_dtype="float32")
    params = jlm.init_params(jc, jax.random.PRNGKey(0))
    return jc, pc, params, stream_batches(jc, STEPS)


@pytest.fixture(scope="module")
def jax_runs(setup):
    """JAX's make_train_step on a one-device mesh: per mode, the three
    losses and the final ``embed``."""
    jc, _, _, batches = setup
    mesh = elastic.build_mesh(elastic.plan_mesh(1, 1))
    out = {}
    for mode in MODES:
        scfg, _ = _scfg_pair(mode)
        with set_mesh(mesh):
            step_fn, *_ = jsteps.make_train_step(
                jc, mesh, scfg, seq_len=seq_len(jc), global_batch=B)
            step = jax.jit(step_fn)
            state = jbuild_state(jc, mesh, scfg)
            losses = []
            for b in batches:
                state, loss = step(state, {k: jnp.asarray(v)
                                           for k, v in b.items()})
                losses.append(float(loss))
        out[mode] = (losses, np.asarray(state["params"]["embed"]))
    return out


@pytest.mark.parametrize("mode", MODES)
def test_train_losses_match_jax(setup, jax_runs, mode):
    jc, pc, params, batches = setup
    _, scfg = _scfg_pair(mode)
    step = psteps.make_train_step(pc, scfg, seq_len=seq_len(pc), batch=B,
                                  device="cpu")
    opt = jax.tree.map(np.asarray, jadamw.init_opt_state(
        params, jadamw.AdamWConfig()))
    state = convert.state_from_jax(
        {"params": jax.tree.map(np.asarray, params), "opt": opt}, pc,
        device="cpu")
    losses = []
    for b in batches:
        state, loss = step(state, psteps.batch_to_device(b, "cpu"))
        losses.append(float(loss))
    want, embed = jax_runs[mode]
    print(f"{jc.name} {mode}: port {losses}, JAX {want}")
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    assert int(state["opt"]["step"]) == STEPS
    if jc.frontend == "audio_stub":  # the unread embed: decay only
        got = state["params"].embed.detach().numpy()
        np.testing.assert_allclose(got, embed, rtol=1e-6, atol=0)
        start = np.asarray(params["embed"])
        assert not np.array_equal(got, start)
        assert not state["opt"]["m"]["embed"].any()
