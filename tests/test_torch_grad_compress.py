"""The port's gradient compression with error feedback against JAX's.

``repro_torch.optim.grad_compress`` on ``gloo`` ranks in subprocesses
on the CPU (this file is also the rank's program), against the JAX
package's ``repro.optim.grad_compress`` in a subprocess with as many
host devices, at 8 ranks and at 3.  Each rank compresses its own
gradients (an f32 matrix, a bf16 vector, a bf16 matrix and an all-zero
leaf, whose scale is the ``1e-30`` floor; from a NumPy seed) for three
steps of error feedback, as the reference's own test calls it (eagerly:
true divisions), then all-reduces the transmitted f32 leaf over the
int8 ring, the pairing the reference names:

  * the transmitted gradients and the residuals equal JAX's bit for bit
    at every step, on every rank;
  * the int8 ring of the transmitted leaf equals the NumPy ring of
    ``test_torch_collectives`` bit for bit and JAX's ``shard_map`` ring
    within one quantization step of the final scale.

In one process: ``quantize_leaf``/``dequantize_leaf`` against JAX's
over magnitudes from 1e-38 to 1e38, exact halves and the all-zero
floor; ``init_error_feedback`` from a mapping and from a model.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from _ranks import finish, gloo_rank, spawn
from test_torch_collectives import q8_ring_numpy

WORLDS = (8, 3)
STEPS = 3
LEAVES = {"w": ((33, 7), "float32"), "b": ((16,), "bfloat16"),
          "e": ((8, 12), "bfloat16"), "zero": ((5,), "float32")}
TIMEOUT_S = 150


def grads(n: int):
    """grads[step][rank][leaf] as f32 NumPy (cast to the leaf's dtype by
    each side); the zero leaf stays zero."""
    rng = np.random.default_rng(3000 + n)
    return [[{name: (np.zeros(shape, np.float32) if name == "zero" else
                     (rng.standard_normal(shape) * 10.0 ** (r - 1))
                     .astype(np.float32))
              for name, (shape, _) in LEAVES.items()}
             for r in range(n)] for _ in range(STEPS)]


def jax_main(n: int, out_dir: str) -> None:
    """Each rank's three compressions (eager, as the reference's own
    test runs them), then the int8 ring of the f32 leaf under
    ``shard_map``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core import chunked_collectives as cc
    from repro.optim import grad_compress as gc
    assert jax.device_count() == n, jax.device_count()
    mesh = jax.make_mesh((n,), ("x",))
    ring = jax.jit(shard_map(lambda x: cc.ring_all_reduce_q8(x, "x")[None],
                             mesh=mesh, in_specs=P("x"), out_specs=P("x"),
                             check_vma=False))
    ef = [gc.init_error_feedback({k: jnp.zeros(s, d) for k, (s, d)
                                  in LEAVES.items()}) for _ in range(n)]
    out = {}
    for step, per_rank in enumerate(grads(n)):
        sent_w = []
        for r, g in enumerate(per_rank):
            g = {k: jnp.asarray(v).astype(LEAVES[k][1]) for k, v in g.items()}
            sent, ef[r] = gc.compress_with_feedback(g, ef[r])
            for k in LEAVES:
                out[f"sent-{step}-{r}-{k}"] = np.asarray(
                    sent[k].astype(jnp.float32))
                out[f"ef-{step}-{r}-{k}"] = np.asarray(ef[r][k])
            sent_w.append(sent["w"])
        out[f"ring-{step}"] = np.asarray(ring(jnp.concatenate(sent_w)))
    np.savez(os.path.join(out_dir, f"jax{n}.npz"), **out)


def rank_main(rank: int, n: int, store_path: str, out_dir: str) -> None:
    from repro_torch.core.chunked_collectives import ring_all_reduce_q8
    from repro_torch.optim import grad_compress as gcm
    dist = gloo_rank(rank, n, store_path)
    try:
        ef = gcm.init_error_feedback(
            {k: torch.zeros(s, dtype=getattr(torch, d))
             for k, (s, d) in LEAVES.items()})
        out, dtypes = {}, {}
        for step, per_rank in enumerate(grads(n)):
            g = {k: torch.from_numpy(v).to(getattr(torch, LEAVES[k][1]))
                 for k, v in per_rank[rank].items()}
            sent, ef = gcm.compress_with_feedback(g, ef)
            for k in LEAVES:
                out[f"sent-{step}-{k}"] = sent[k].float().numpy()
                out[f"ef-{step}-{k}"] = ef[k].numpy()
                dtypes[k] = [str(sent[k].dtype), str(ef[k].dtype)]
            out[f"ring-{step}"] = ring_all_reduce_q8(sent["w"]).numpy()
        np.savez(os.path.join(out_dir, f"port{n}-{rank}.npz"), **out)
        with open(os.path.join(out_dir, f"dtypes{n}-{rank}.json"),
                  "w") as fh:
            json.dump(dtypes, fh)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("grad_compress")
    procs = []
    for n in WORLDS:
        procs.append(spawn(__file__, "jax", n, out, devices=n))
        procs += [spawn(__file__, "rank", r, n, out / f"store{n}", out)
                  for r in range(n)]
    finish(procs, TIMEOUT_S)
    return {n: {"jax": dict(np.load(out / f"jax{n}.npz")),
                "port": [dict(np.load(out / f"port{n}-{r}.npz"))
                         for r in range(n)],
                "dtypes": [json.loads((out / f"dtypes{n}-{r}.json")
                                      .read_text()) for r in range(n)]}
            for n in WORLDS}


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("leaf", list(LEAVES))
def test_feedback_equals_jax_bitwise(results, n, step, leaf):
    res = results[n]
    for r in range(n):
        for what in ("sent", "ef"):
            np.testing.assert_array_equal(
                res["port"][r][f"{what}-{step}-{leaf}"],
                res["jax"][f"{what}-{step}-{r}-{leaf}"],
                err_msg=f"{what} rank {r}")


@pytest.mark.parametrize("n", WORLDS)
def test_dtypes_and_bounded_residual(results, n):
    """The transmitted leaf keeps its dtype, the residual is f32, and
    the residual of an f32 leaf is at most half a quantization step."""
    for r in range(n):
        for k, (_, dt) in LEAVES.items():
            assert results[n]["dtypes"][r][k] == [f"torch.{dt}",
                                                  "torch.float32"]
        for step in range(STEPS):
            ef = results[n]["port"][r][f"ef-{step}-w"]
            sent = results[n]["port"][r][f"sent-{step}-w"]
            step_size = np.abs(sent + ef).max() / 127.0
            assert np.abs(ef).max() <= 0.5 * step_size * (1 + 1e-6)
            assert not results[n]["port"][r][f"sent-{step}-zero"].any()


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("step", range(STEPS))
def test_ring_of_transmitted_leaf(results, n, step):
    res = results[n]
    sent = np.stack([res["port"][r][f"sent-{step}-w"] for r in range(n)])
    want = q8_ring_numpy(sent)
    jax_ring = res["jax"][f"ring-{step}"]
    step_size = np.abs(jax_ring[0]).max() / 127.0
    for r in range(n):
        got = res["port"][r][f"ring-{step}"]
        np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")
        assert np.abs(got - jax_ring[r]).max() <= step_size


# ---------------------------------------------------------------------------
# In one process
# ---------------------------------------------------------------------------

def _leaf_cases():
    rng = np.random.default_rng(11)
    yield "zero", np.zeros(7, np.float32)
    yield "halves", np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0],
                             np.float32)
    for e in (-38, -20, -8, 0, 8, 20, 37):
        yield f"1e{e}", (rng.standard_normal(257) * 10.0 ** e).astype(
            np.float32)


@pytest.mark.parametrize("name,x", list(_leaf_cases()))
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_quantize_leaf_equals_jax(name, x, dt):
    import jax.numpy as jnp

    from repro.optim import grad_compress as gc
    from repro_torch.optim import grad_compress as gcm
    qj, sj = gc.quantize_leaf(jnp.asarray(x).astype(dt))
    qp, sp = gcm.quantize_leaf(torch.from_numpy(x).to(getattr(torch, dt)))
    assert qp.dtype == torch.int8 and sp.dtype == getattr(torch, dt)
    np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(sp.float().numpy(),
                                  np.asarray(sj.astype(jnp.float32)))
    np.testing.assert_array_equal(
        gcm.dequantize_leaf(qp, sp).numpy(),
        np.asarray(gc.dequantize_leaf(qj, sj).astype(jnp.float32)))


def test_init_error_feedback_from_mapping_and_model():
    from repro_torch import serve
    from repro_torch.configs import get_smoke_config
    from repro_torch.optim import grad_compress as gcm
    ef = gcm.init_error_feedback({"a": torch.ones(3, 2,
                                                  dtype=torch.bfloat16)})
    assert ef["a"].dtype == torch.float32 and not ef["a"].any()
    model = serve.build_model(get_smoke_config("llama3.2-1b"), 0, "cpu")
    ef = gcm.init_error_feedback(model)
    assert {k: tuple(v.shape) for k, v in ef.items()} == {
        k: tuple(p.shape) for k, p in model.named_parameters()}


if __name__ == "__main__":
    torch.set_num_threads(1)
    if sys.argv[1] == "jax":
        jax_main(int(sys.argv[2]), sys.argv[3])
    else:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                  sys.argv[5])
