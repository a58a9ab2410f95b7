"""Training of every architecture on the port against the JAX package.

For each of the ten smoke configs in f32, with the JAX package's
``init_params(PRNGKey(0))`` carried across and the data stream's
batches (qwen2-vl at S 96, over its 64 patches, with explicit M-RoPE
positions in both packages: a 1 x 8 x 8 t/h/w grid over the patches,
then text), the step-0 synced gradients of ``value_and_synced_grad``
must equal JAX's ``value_and_grad(loss_fn)`` within ``rtol=2e-4,
atol=2e-5`` in the three sync modes (bulk, per_leaf, partitioned), and
each mode's all-reduces must be one per bucket of JAX's ``make_plan``
over the same leaves plus one for the loss.  MoE near-ties (router gap
at the k-th expert under 1e-5) are counted and printed, never re-seeded
away.  musicgen's ``embed``, which its audio stub never reads, gets
JAX's zero gradient.  Also: MoE's layer-level checkpointing against no
remat, and the training CLI for every architecture (qwen2-vl refused
with its reason).  The three-step losses against JAX's
``make_train_step`` are in ``test_torch_train_losses.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import bucketing as jb
from repro.models import lm as jlm
from repro_torch.configs import get_smoke_config as psmoke
from repro_torch.core.earlybird import SyncConfig, value_and_synced_grad
from repro_torch.launch import steps as psteps
from repro_torch.launch import train as ptrain
from repro_torch.models import convert, lm as plm, moe as pmoe

from _torch_models import gloo_group, stream_batches  # noqa: F401

ARCHS = sorted(jconfigs.ARCH_IDS)
MODES = ("bulk", "per_leaf", "partitioned")
B = 2
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)   # check_earlybird.py
LOSS_RTOL = 1e-5
AGGR = 1 << 12  # small buckets: the smoke layers split into several
TIE_GAP = 1e-5


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jc = jconfigs.get_smoke_config(arch).replace(param_dtype="float32")
    pc = psmoke(arch).replace(param_dtype="float32")
    params = jlm.init_params(jc, jax.random.PRNGKey(0))
    return jc, pc, params, stream_batches(jc, 1)[0]


@pytest.fixture(scope="module")
def jax_grads(setup):
    """JAX's single-program loss and gradients on batch 0."""
    jc, _, params, batch = setup
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jc, p, b)))(params, jbatch)


def _model(pc, params):
    model = convert.params_from_jax(jax.tree.map(np.asarray, params), pc,
                                    device="cpu")
    return model.requires_grad_(True)


def reference_buckets(jc, mode: str) -> int:
    """Buckets of the JAX package's plans for one step of ``mode`` on the
    stacked f32 leaves: the whole tree at 256 MiB (bulk) or 0 (per_leaf);
    each layer's leaves at ``AGGR`` plus the rest at ``AGGR``
    (partitioned)."""
    shapes = jlm.param_shapes(jc)
    if mode != "partitioned":
        aggr = 256 << 20 if mode == "bulk" else 0
        return jb.make_plan(jax.tree.leaves(shapes), aggr).n_buckets
    layer = [jax.ShapeDtypeStruct(s.shape[1:], s.dtype)
             for s in jax.tree.leaves(shapes["layers"])]
    rest = [v for k, v in shapes.items() if k != "layers"]
    return (jc.n_layers * jb.make_plan(layer, AGGR).n_buckets
            + jb.make_plan(jax.tree.leaves(rest), AGGR).n_buckets)


def _router_ties(model, pc, batch):
    """Tokens (any layer) whose router gap at the k-th expert is under
    ``TIE_GAP``, from a forward that records the router logits."""
    rec = []
    real = pmoe.router_top_k

    def spy(p, xc, mo):
        rec.append((xc @ p.router.to(xc.dtype)).float()[:, :mo.n_experts])
        return real(p, xc, mo)
    pmoe.router_top_k = spy
    try:
        with torch.no_grad():
            plm.forward(pc, model, batch)
    finally:
        pmoe.router_top_k = real
    k, ties = pc.moe.top_k, set()
    for r in rec:
        srt = np.sort(r.numpy(), axis=-1)[:, ::-1]
        ties |= set(np.flatnonzero(srt[:, k - 1] - srt[:, k] < TIE_GAP)
                    .tolist())
    return ties


@pytest.mark.parametrize("mode", MODES)
def test_step0_synced_grads_match_jax(setup, jax_grads, mode):
    """The synced gradients of every leaf, the loss, and the all-reduce
    count against JAX's plan."""
    jc, pc, params, batch = setup
    want_loss, want = jax_grads
    model = _model(pc, params)
    b = psteps.batch_to_device(batch, "cpu")
    if pc.moe is not None:
        ties = _router_ties(model, pc, b)
        print(f"{jc.name}: {len(ties)} MoE near-tie tokens {sorted(ties)}")
    vg = value_and_synced_grad(
        lambda m, bb, param_hook: plm.loss_fn(pc, m, bb,
                                              param_hook=param_hook),
        SyncConfig(mode=mode, aggr_bytes=AGGR))
    loss, grads = vg(model, b)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    got = convert.named_to_jax(grads)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(k) for k, _ in flat_w] == \
        [jax.tree_util.keystr(k) for k, _ in flat_g]
    for (kp, a), (_, g) in zip(flat_w, flat_g):
        np.testing.assert_allclose(g, np.asarray(a), **GRAD_TOL,
                                   err_msg=f"{jc.name} {mode}: {kp}")
    assert vg.log.count() == reference_buckets(jc, mode) + 1
    layer_tags = [t for t, _ in vg.log.entries if t.startswith("layer")]
    assert bool(layer_tags) == (mode == "partitioned")
    if jc.frontend == "audio_stub":  # unread by the stub: zeros, as JAX's
        assert not np.asarray(want["embed"]).any()
        assert not grads["embed"].any() and grads["embed"].shape == \
            model.embed.shape


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "moonshot-v1-16b-a3b"])
def test_moe_layer_checkpoint_gives_the_same_grads(arch):
    """JAX checkpoints each dispatch chunk; the port checkpoints each
    layer.  Recomputation changes no value: the gradients with and
    without ``remat`` are equal."""
    cfg = psmoke(arch).replace(param_dtype="float32")
    batch = psteps.batch_to_device(stream_batches(cfg, 1)[0], "cpu")
    out = []
    for remat in (False, True):
        model = psteps.build_state(cfg, 0, "cpu")["params"]
        plm.loss_fn(cfg, model, batch, remat=remat).backward()
        out.append({n: p.grad for n, p in model.named_parameters()})
    for n, g in out[0].items():
        torch.testing.assert_close(out[1][n], g, rtol=1e-6, atol=1e-7)


def test_unread_embed_is_named_by_the_config():
    """Only the audio stub's ``embed`` is unread; a model whose config
    names nothing still reports a parameter without gradient."""
    assert [a for a in ARCHS if plm.unread_params(psmoke(a))] == \
        ["musicgen-medium"]
    cfg = psmoke("musicgen-medium")
    assert plm.unread_params(cfg.replace(tie_embeddings=True)) == ()
    model = psteps.build_state(cfg, 0, "cpu")["params"]
    vg = value_and_synced_grad(
        lambda m, b, param_hook: sum(p.sum() for n, p in m.named_parameters()
                                     if n not in ("embed", "final_norm")),
        SyncConfig(mode="bulk"))
    with pytest.raises(RuntimeError, match="final_norm got no gradient"):
        vg(model, None)
    assert model.embed.grad is not None and not model.embed.grad.any()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_on_cpu(arch, capsys, tmp_path):
    """Every architecture trains through the CLI but qwen2-vl, which the
    stream cannot feed (no M-RoPE positions), as JAX's CLI."""
    rc = ptrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--steps", "2", "--seq-len", "32",
                      "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr()
    if arch == "qwen2-vl-7b":
        assert rc == 2
        assert "positions" in out.err and "repro.launch.train" in out.err
        return
    assert rc == 0
    rec = json.loads(out.out.strip().splitlines()[-1])
    assert rec["arch"] == arch + "-smoke" and rec["steps"] == 2
    assert np.isfinite(rec["losses"]).all()
