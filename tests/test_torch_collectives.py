"""The port's ring collectives against the JAX package's, across ranks.

``repro_torch.core.chunked_collectives`` runs on ``gloo`` ranks in
subprocesses on the CPU (this file is also the rank's program); the JAX
package's ``repro.core.chunked_collectives`` runs under ``shard_map`` in
a subprocess with as many host devices (``XLA_FLAGS``), as
``tests/multidev_scripts/check_collectives.py`` runs it.  Both take the
same per-rank inputs, made from a NumPy seed, at 8 ranks (the
reference's) and 3 (odd: the all-reduce pads), every function at 1, 2
and 4 channels where it takes them:

  * all-gather (tiled and stacked), reduce-scatter and all-reduce in
    f32 equal JAX's bit for bit: the ring fixes the order of the adds;
  * the int8 ring (``ring_all_reduce_q8``) equals a NumPy run of the
    same ring bit for bit (each hop's scale ``max|v| * float32(1/127)``,
    as XLA rewrites the reference's ``/ 127.0``; each dequantize-and-add
    rounded twice, as the program is written), JAX's within one
    quantization step of the final scale (XLA's CPU code contracts
    ``q * scale + chunk`` into a fused multiply-add, one rounding, so
    about half the elements differ by an ulp), and the reference's own
    bound holds (error < 0.1 of the scale);
  * the two collective matmuls meet JAX's within ``rtol=atol=1e-5``
    (the block products are BLAS's and XLA's own dots);
  * every result meets the plain NumPy sum or product;
  * the point-to-point messages a rank posts are the ring's: N-1 hops of
    each channel stream, two messages a hop (payload and scale) on the
    int8 ring.

The ``gpu`` tests run the one-rank path on the card (phase 19 of
``chip_smoke.py`` at a small size) and skip without one.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from _ranks import finish, gloo_rank, spawn

WORLDS = (8, 3)
CHANNELS = (1, 2, 4)
TIMEOUT_S = 150
MATMUL_TOL = 1e-5


def case_table(n: int) -> dict:
    """name -> (function, keyword arguments, per-rank inputs (arrays
    with a leading rank axis), replicated inputs), from a NumPy seed."""
    rng = np.random.default_rng(1000 + n)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    x_ag = f(n, 4, 16)
    y = f(n, n, 4, 16)       # rank r's contributions y[r], block b: y[r, b]
    z = f(n, 33, 7)          # deliberately awkward size
    xs, w = f(n, 4, 16), f(16, 24)
    xb, wb = f(n * 2, n * 16), f(n * 16, 12)
    cases = {}
    for c in CHANNELS:
        cases[f"ag_tiled_{c}"] = ("ring_all_gather",
                                  {"n_channels": c, "tiled": True},
                                  [x_ag], [])
        cases[f"ag_stacked_{c}"] = ("ring_all_gather", {"n_channels": c},
                                    [x_ag], [])
        cases[f"rs_{c}"] = ("ring_reduce_scatter", {"n_channels": c}, [y],
                            [])
        cases[f"ar_{c}"] = ("ring_all_reduce", {"n_channels": c}, [z], [])
    cases["q8"] = ("ring_all_reduce_q8", {}, [z], [])
    cases["ag_matmul"] = ("collective_ag_matmul", {}, [xs], [w])
    # x column-sharded, w row-sharded: rank r holds x[:, r*16:(r+1)*16]
    cases["matmul_rs"] = ("collective_matmul_rs", {},
                          [xb.reshape(n * 2, n, 16).transpose(1, 0, 2).copy(),
                           wb.reshape(n, 16, 12)], [])
    return cases


def direct(name: str, n: int, sharded, replicated) -> list:
    """Each rank's result by plain NumPy sums and products."""
    x = sharded[0]
    if name.startswith("ag_tiled"):
        return [x.reshape(-1, x.shape[-1])] * n
    if name.startswith("ag_stacked"):
        return [x] * n
    if name.startswith("rs"):
        return list(x.sum(0))
    if name.startswith("ar") or name == "q8":
        return [x.sum(0)] * n
    if name == "ag_matmul":
        return [x.reshape(-1, x.shape[-1]) @ replicated[0]] * n
    full = np.concatenate(list(x), axis=1) @ np.concatenate(
        list(sharded[1]), axis=0)
    return list(full.reshape(n, -1, full.shape[-1]))


def expected_messages(name: str, n: int) -> int:
    """Point-to-point messages one rank posts for a case."""
    if name == "q8":
        return 2 * 2 * (n - 1)  # payload + scale, reduce-scatter + gather
    if name in ("ag_matmul", "matmul_rs"):
        return n - 1
    c = int(name.rsplit("_", 1)[1])
    hops = 2 * (n - 1) if name.startswith("ar") else n - 1
    return c * hops


def jax_main(n: int, out_dir: str) -> None:
    """The JAX package's collectives on ``n`` host devices: each case
    under ``shard_map``, every rank's result saved."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core import chunked_collectives as cc
    assert jax.device_count() == n, jax.device_count()
    mesh = jax.make_mesh((n,), ("x",))
    out = {}
    for name, (fn, kw, sharded, replicated) in case_table(n).items():
        def body(*args, fn=getattr(cc, fn), kw=kw):
            return fn(*args, "x", **kw)[None]
        specs = ((P("x"),) * len(sharded) + (P(),) * len(replicated))
        f = jax.jit(shard_map(body, mesh=mesh, in_specs=specs,
                              out_specs=P("x"), check_vma=False))
        args = [a.reshape(-1, *a.shape[2:]) for a in sharded] + replicated
        out[name] = np.asarray(f(*args))
    np.savez(os.path.join(out_dir, f"jax{n}.npz"), **out)


def rank_main(rank: int, n: int, store_path: str, out_dir: str) -> None:
    """One rank of the port: every case on its shard."""
    from repro_torch import compat
    from repro_torch.core import chunked_collectives as cc
    dist = gloo_rank(rank, n, store_path)
    try:
        out, msgs = {}, {}
        for name, (fn, kw, sharded, replicated) in case_table(n).items():
            args = ([torch.from_numpy(a[rank]) for a in sharded]
                    + [torch.from_numpy(a) for a in replicated])
            before = compat.CALLS["ppermute"]
            out[name] = getattr(cc, fn)(*args, **kw).numpy()
            msgs[name] = compat.CALLS["ppermute"] - before
        np.savez(os.path.join(out_dir, f"port{n}-{rank}.npz"), **out)
        with open(os.path.join(out_dir, f"msgs{n}-{rank}.json"), "w") as fh:
            json.dump(msgs, fh)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """JAX's and every rank's results at both world sizes, all processes
    started together."""
    out = tmp_path_factory.mktemp("collectives")
    procs = []
    for n in WORLDS:
        procs.append(spawn(__file__, "jax", n, out, devices=n))
        procs += [spawn(__file__, "rank", r, n, out / f"store{n}", out)
                  for r in range(n)]
    finish(procs, TIMEOUT_S)
    res = {}
    for n in WORLDS:
        res[n] = {
            "jax": dict(np.load(out / f"jax{n}.npz")),
            "port": [dict(np.load(out / f"port{n}-{r}.npz"))
                     for r in range(n)],
            "msgs": [json.loads((out / f"msgs{n}-{r}.json").read_text())
                     for r in range(n)]}
    return res


def _both(results, n, name):
    res = results[n]
    return [p[name] for p in res["port"]], res["jax"][name]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("kind", ["ag_tiled", "ag_stacked", "rs", "ar"])
def test_f32_rings_equal_jax_bitwise(results, n, c, kind):
    port, want = _both(results, n, f"{kind}_{c}")
    for r in range(n):
        assert port[r].dtype == want[r].dtype
        np.testing.assert_array_equal(port[r], want[r],
                                      err_msg=f"{kind} c={c} rank {r}")


def q8_ring_numpy(x: np.ndarray) -> np.ndarray:
    """The int8 ring on the per-rank inputs ``x`` (n, ...), in NumPy:
    the result every rank ends with."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    pad = (-flat.shape[1]) % n
    chunks = np.pad(flat, ((0, 0), (0, pad))).reshape(n, n, -1)
    inv = np.float32(1) / np.float32(127)

    def q(v):
        s = np.maximum(np.abs(v).max(), np.float32(1e-30)) * inv
        return np.round(v / s).astype(np.int8), s

    def dq(qv, s):
        return qv.astype(np.float32) * s
    acc = [chunks[r, (r - 1) % n] for r in range(n)]
    for s in range(1, n):
        sent = [q(a) for a in acc]  # rank r receives rank r-1's
        acc = [dq(*sent[(r - 1) % n]) + chunks[r, (r - s - 1) % n]
               for r in range(n)]
    full = np.concatenate([dq(*q(a)) for a in acc])
    return full[:flat.shape[1]].reshape(x.shape[1:])


@pytest.mark.parametrize("n", WORLDS)
def test_q8_ring_equals_numpy_ring_bitwise(results, n):
    x = case_table(n)["q8"][2][0]
    want = q8_ring_numpy(x)
    for r in range(n):
        np.testing.assert_array_equal(results[n]["port"][r]["q8"], want,
                                      err_msg=f"q8 rank {r}")


@pytest.mark.parametrize("n", WORLDS)
def test_q8_ring_matches_jax(results, n):
    """Within one quantization step of the final scale of JAX's, and
    within the reference's own bound of the exact sum."""
    port, want = _both(results, n, "q8")
    exact = case_table(n)["q8"][2][0].sum(0)
    scale = np.abs(exact).max()
    step = np.abs(want[0]).max() / 127.0
    for r in range(n):
        err_jax = np.abs(port[r] - want[r]).max()
        assert err_jax <= step, (r, err_jax, step)
        err = np.abs(port[r] - exact).max()
        assert err < 0.1 * scale, (err, scale)  # the reference's bound


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", ["ag_matmul", "matmul_rs"])
def test_collective_matmuls_match_jax(results, n, name):
    port, want = _both(results, n, name)
    for r in range(n):
        np.testing.assert_allclose(port[r], want[r], rtol=MATMUL_TOL,
                                   atol=MATMUL_TOL, err_msg=f"rank {r}")


@pytest.mark.parametrize("n", WORLDS)
def test_results_equal_plain_sums(results, n):
    """Every case against NumPy's sums and products (the q8 ring to its
    bound, above): the port is right on its own, not only like JAX."""
    for name, (_, _, sharded, replicated) in case_table(n).items():
        if name == "q8":
            continue
        want = direct(name, n, sharded, replicated)
        for r in range(n):
            got = results[n]["port"][r][name]
            np.testing.assert_allclose(got, want[r], rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("n", WORLDS)
def test_messages_are_the_rings(results, n):
    for r in range(n):
        msgs = results[n]["msgs"][r]
        assert msgs == {name: expected_messages(name, n)
                        for name in msgs}, r


def test_channel_split_and_merge_round_trip():
    from repro_torch.core import chunked_collectives as cc
    x = torch.arange(24.0).reshape(12, 2)
    for k in (1, 2, 3, 4):
        parts = cc._split_channels(x, k)
        assert [p.shape[0] for p in parts] == [12 // k] * k
        assert torch.equal(cc._merge_channels(parts, k), x)
    with pytest.raises(ValueError):
        cc._split_channels(x, 5)
    assert cc._ring_perm(3) == [(0, 1), (1, 2), (2, 0)]
    assert cc._ring_perm(3, reverse=True) == [(0, 2), (1, 0), (2, 1)]


# ---------------------------------------------------------------------------
# On the card: the one-rank path (phase 19 of chip_smoke.py, small)
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_one_rank(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    import torch.distributed as dist
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "s"), 1))
    try:
        yield torch.device("cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_one_rank_collectives_on_the_card(nccl_one_rank):
    from repro_torch.core import chunked_collectives as cc
    dev = nccl_one_rank
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(64, 48, generator=gen, device=dev)
    w = torch.randn(48, 40, generator=gen, device=dev)
    for c in CHANNELS:
        assert torch.equal(cc.ring_all_gather(x, n_channels=c, tiled=True), x)
        assert torch.equal(cc.ring_all_gather(x, n_channels=c)[0], x)
        assert torch.equal(cc.ring_reduce_scatter(x[None], n_channels=c), x)
        assert torch.equal(cc.ring_all_reduce(x, n_channels=c), x)
    assert torch.equal(cc.ring_all_reduce_q8(x), cc._dq8(*cc._q8(x)))
    assert torch.equal(cc.collective_ag_matmul(x, w), x @ w)
    assert torch.equal(cc.collective_matmul_rs(x, w), x @ w)


@pytest.mark.gpu
def test_card_scales_divide_by_a_device_tensor(nccl_one_rank):
    """The scales on the card equal the CPU's bit for bit: the divisions
    take a device tensor, not a host scalar (which CUDA multiplies by
    its reciprocal)."""
    from repro_torch.core import chunked_collectives as cc
    from repro_torch.optim import grad_compress as gcm
    dev = nccl_one_rank
    rng = np.random.default_rng(5)
    for _ in range(20):
        x = torch.from_numpy(
            (rng.standard_normal(4097) * 10.0 ** rng.uniform(-8, 8))
            .astype(np.float32))
        q_cpu, s_cpu = gcm.quantize_leaf(x)
        q_dev, s_dev = gcm.quantize_leaf(x.to(dev))
        assert torch.equal(s_dev.cpu(), s_cpu)
        assert torch.equal(q_dev.cpu(), q_cpu)
        assert torch.equal(cc._q8(x.to(dev))[1].cpu(), cc._q8(x)[1])
        assert torch.equal(cc.ring_all_reduce_q8(x.to(dev)).cpu(),
                           cc.ring_all_reduce_q8(x))


@pytest.mark.gpu
def test_grad_compress_on_the_card_equals_the_cpu(nccl_one_rank):
    from repro_torch.optim import grad_compress as gcm
    dev = nccl_one_rank
    rng = np.random.default_rng(6)
    leaves = {"w": torch.float32, "b": torch.bfloat16}
    ef_c = {k: torch.zeros(300) for k in leaves}
    ef_d = {k: v.to(dev) for k, v in ef_c.items()}
    for _ in range(3):
        g = {k: torch.from_numpy(rng.standard_normal(300).astype(
            np.float32)).to(dt) for k, dt in leaves.items()}
        sent_c, ef_c = gcm.compress_with_feedback(g, ef_c)
        sent_d, ef_d = gcm.compress_with_feedback(
            {k: v.to(dev) for k, v in g.items()}, ef_d)
        for k in leaves:
            assert torch.equal(sent_d[k].cpu(), sent_c[k])
            assert torch.equal(ef_d[k].cpu(), ef_c[k])


if __name__ == "__main__":
    torch.set_num_threads(1)
    if sys.argv[1] == "jax":
        jax_main(int(sys.argv[2]), sys.argv[3])
    else:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                  sys.argv[5])
