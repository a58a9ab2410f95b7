"""The port's partitioned-KV flash decode against the JAX package's.

``repro_torch.core.flash_decode`` runs on ``gloo`` ranks in
subprocesses on the CPU (this file is also the rank's program); the JAX
package's ``repro.core.flash_decode`` runs under ``shard_map`` in a
subprocess with as many host devices, as
``tests/multidev_scripts/check_flash_decode.py`` runs it.  At 8 ranks
(S 64, the reference's) and 3 (S 63), on the four cases of that script,
in f32 and in bf16 (q and the cache), and on partitions of 2600 keys a
rank (two runs of ``PV_CHUNK`` and a tail, in f32), inputs from a NumPy
seed:

  * every rank's ``flash_decode_shard`` meets JAX's and the full-KV
    oracle ``flash_decode_ref`` within ``rtol=2e-4, atol=2e-5``; the
    port's oracle meets JAX's the same way;
  * every rank ends with the same result, after three ``all_reduce``
    calls (one max, two sums); a per-layer window given as a tensor
    equals the same window given as an int.

Then the decode hook through the models: ``make_decode_step`` with
``StepConfig.flash_decode`` on one and on two ranks, on the smoke
configs of llama3.2-1b, gemma2-9b (alternating window 8 and softcap),
hymba-1.5b at 4 layers (its middle layers' window 8 bites) and qwen2-7b
at 14 heads over 2 KV heads padded to 16 (``tp_pad`` 8; the full
config's group of 7 padded 28 -> 32 at 8-way TP, which the smoke
config's single KV head cannot show): the non-uniform head map falls
back to ``masked_attention``, as in JAX.  Four teacher-forced
decode steps after a 24-token prefill meet JAX's ``lm.decode_step`` on
one device within 1e-4 in f32, both its plain decode and its decode
through a ``decode_attn`` hook built from ``flash_decode_ref``; each
step issues three ``all_reduce`` calls per attention layer (none for
qwen2-7b).  JAX's sharded ``make_decode_step`` is not the reference:
its lowering fails on this jax (``test_launch_steps_mini_dryrun``).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from _ranks import finish, gloo_rank, spawn

WORLDS = (8, 3)
B, H, KV, D = 2, 4, 2, 16
DTYPES = ("float32", "bfloat16")
RTOL, ATOL = 2e-4, 2e-5
TIMEOUT_S = 150

# The decode hook: (arch, config changes), ranks, prompt, steps.
HOOK_ARCHS = (("llama3.2-1b", {}), ("gemma2-9b", {}),
              ("hymba-1.5b", {"n_layers": 4}),
              ("qwen2-7b", {"n_heads": 14, "n_kv": 2, "tp_pad": 8}))
HOOK_WORLDS = (1, 2)
PROMPT, GEN = 24, 4
HOOK_TOL = 1e-4


# A long partition, 2600 keys a rank: two runs of PV_CHUNK and a tail.
LONG = 2600


def seq_len(n: int, long: bool = False) -> int:
    if long:
        return LONG * n
    return 64 if 64 % n == 0 else 63


def cases(n: int, long: bool = False):
    """(pos, window, softcap) of ``check_flash_decode.py`` at S; on the
    long partitions the last position and a window at mid-sequence."""
    s = seq_len(n, long)
    if long:
        return [(s - 1, 0, None), (s // 2, 3000, 50.0)]
    return [(s - 1, 0, None), (17, 0, None), (s - 1, 24, None),
            (40, 16, 50.0)]


def inputs(n: int, long: bool = False):
    rng = np.random.default_rng(2000 + n + long)
    s = seq_len(n, long)
    return (rng.standard_normal((B, H, D)).astype(np.float32),
            rng.standard_normal((B, s, KV, D)).astype(np.float32),
            rng.standard_normal((B, s, KV, D)).astype(np.float32))


def case_keys(n: int):
    """(key, dtype, long, case) of every flash-decode case at n ranks:
    the four cases in f32 and bf16, and the long ones in f32."""
    out = [(f"{dt}-{i}", dt, False, c) for dt in DTYPES
           for i, c in enumerate(cases(n))]
    return out + [(f"long-{i}", "float32", True, c)
                  for i, c in enumerate(cases(n, True))]


def jax_main(n: int, out_dir: str) -> None:
    """JAX's shard (every rank's result) and oracle for every case."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core.flash_decode import flash_decode_ref, flash_decode_shard
    assert jax.device_count() == n, jax.device_count()
    mesh = jax.make_mesh((n,), ("x",))
    out = {}
    for key, dt, long, (pos, window, cap) in case_keys(n):
        q, k, v = (jnp.asarray(a).astype(dt) for a in inputs(n, long))
        kw = dict(pos=jnp.int32(pos), window=window, attn_softcap=cap,
                  scale=D ** -0.5)
        out[f"ref-{key}"] = np.asarray(
            flash_decode_ref(q, k, v, **kw).astype(jnp.float32))

        def f(q_, k_, v_, kw=kw):
            return flash_decode_shard(q_, k_, v_, axis="x", **kw)[None]
        got = jax.jit(shard_map(
            f, mesh=mesh, in_specs=(P(), P(None, "x"), P(None, "x")),
            out_specs=P("x"), check_vma=False))(q, k, v)
        out[f"shard-{key}"] = np.asarray(got.astype(jnp.float32))
    np.savez(os.path.join(out_dir, f"jax{n}.npz"), **out)


def rank_main(rank: int, n: int, store_path: str, out_dir: str) -> None:
    """One rank: its sequence slice of every case, and the oracle."""
    from repro_torch import compat
    from repro_torch.core.flash_decode import (flash_decode_ref,
                                               flash_decode_shard)
    dist = gloo_rank(rank, n, store_path)
    try:
        out, calls = {}, []
        for key, dt, long, (pos, window, cap) in case_keys(n):
            s_local = seq_len(n, long) // n
            sl = slice(rank * s_local, (rank + 1) * s_local)
            q, k, v = (torch.from_numpy(a).to(getattr(torch, dt))
                       for a in inputs(n, long))
            kw = dict(pos=pos, window=window, attn_softcap=cap,
                      scale=D ** -0.5)
            before = compat.CALLS["all_reduce"]
            got = flash_decode_shard(q, k[:, sl], v[:, sl], **kw)
            calls.append(compat.CALLS["all_reduce"] - before)
            out[f"shard-{key}"] = got.float().numpy()
            out[f"ref-{key}"] = flash_decode_ref(q, k, v, **kw).float().numpy()
            kw["window"] = torch.tensor(window)  # a per-layer tensor
            out[f"tensor-window-{key}"] = flash_decode_shard(
                q, k[:, sl], v[:, sl], **kw).float().numpy()
        np.savez(os.path.join(out_dir, f"port{n}-{rank}.npz"), **out)
        with open(os.path.join(out_dir, f"calls{n}-{rank}.json"), "w") as fh:
            json.dump(calls, fh)
    finally:
        dist.destroy_process_group()


def port_config(arch: str, changes: dict):
    from repro_torch import configs as pconfigs
    return pconfigs.get_smoke_config(arch).replace(**changes)


def hook_tokens(vocab: int):
    """The prompt (B, PROMPT) and the GEN teacher-forced tokens (GEN,
    B)."""
    rng = np.random.default_rng(7)
    return (rng.integers(0, vocab, (B, PROMPT)).astype(np.int32),
            rng.integers(0, vocab, (GEN, B)).astype(np.int32))


def attention_layers(cfg) -> int:
    """Layers whose attention takes the hook: GQA under the uniform head
    map (MLA and Mamba never take it)."""
    if cfg.mixer not in ("attn", "hybrid") or cfg.mla is not None:
        return 0
    h, kv = cfg.n_heads_padded, cfg.n_kv
    uniform = h % kv == 0 and tuple(cfg.head_map) == tuple(
        i // (h // kv) for i in range(h))
    return cfg.n_layers if uniform else 0


def hook_main(rank: int, n: int, store_path: str, out_dir: str) -> None:
    """One rank of the decode hook: a prefill, then GEN decode steps
    through ``make_decode_step`` with ``flash_decode``."""
    from repro_torch import compat, serve
    from repro_torch.launch.steps import StepConfig, make_decode_step
    from repro_torch.models import lm
    dist = gloo_rank(rank, n, store_path)
    try:
        scfg = StepConfig(param_dtype="float32", cache_dtype="float32",
                          flash_decode=True)
        out, calls = {}, {}
        for arch, changes in HOOK_ARCHS:
            cfg = port_config(arch, changes)
            model = serve.build_model(cfg, 0, "cpu")
            prompt, feed = hook_tokens(cfg.vocab)
            cache = lm.init_cache(cfg, B, PROMPT + GEN, device="cpu")
            lm.prefill(cfg, model, {"tokens": torch.from_numpy(prompt)},
                       cache=cache)
            step = make_decode_step(cfg, scfg, seq_len=PROMPT + GEN,
                                    batch=B, device="cpu")
            calls[arch] = []
            for t in range(GEN):
                before = compat.CALLS["all_reduce"]
                logits, cache = step(model, cache,
                                     torch.from_numpy(feed[t]), PROMPT + t)
                calls[arch].append(compat.CALLS["all_reduce"] - before)
                out[f"{arch}-{t}"] = logits.numpy()
        try:
            make_decode_step(cfg, scfg, seq_len=PROMPT + GEN + 1, batch=B,
                             device="cpu")
            calls["odd_cache_raises"] = False
        except ValueError:
            calls["odd_cache_raises"] = True
        np.savez(os.path.join(out_dir, f"hook{n}-{rank}.npz"), **out)
        with open(os.path.join(out_dir, f"hookcalls{n}-{rank}.json"),
                  "w") as fh:
            json.dump(calls, fh)
    finally:
        dist.destroy_process_group()


def jax_decodes():
    """JAX's logits of every hook case on one device: its plain decode,
    and its decode through a hook built from ``flash_decode_ref``."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core.flash_decode import flash_decode_ref
    from repro.models import lm as jlm
    from repro_torch import serve
    from repro_torch.models import convert

    def ref_hook(q, k, v, *, pos, window, attn_softcap, scale):
        return flash_decode_ref(q, k, v, pos=pos, window=window,
                                attn_softcap=attn_softcap, scale=scale)
    out = {}
    for arch, changes in HOOK_ARCHS:
        jc = jconfigs.get_smoke_config(arch).replace(**changes)
        model = serve.build_model(port_config(arch, changes), 0, "cpu")
        params = jax.tree.map(jnp.asarray, convert.named_to_jax(
            dict(model.named_parameters())))
        prompt, feed = hook_tokens(jc.vocab)
        _, cache0 = jlm.prefill(jc, params, {"tokens": jnp.asarray(prompt)},
                                cache=jlm.init_cache(jc, B, PROMPT + GEN))
        for name, hook in (("plain", None), ("ref", ref_hook)):
            cache = cache0
            for t in range(GEN):
                logits, cache = jlm.decode_step(
                    jc, params, cache, jnp.asarray(feed[t]),
                    jnp.int32(PROMPT + t), decode_attn=hook)
                out[(name, arch, t)] = np.asarray(logits)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every process started together; JAX's decodes computed here
    meanwhile."""
    out = tmp_path_factory.mktemp("flash_decode")
    procs = []
    for n in WORLDS:
        procs.append(spawn(__file__, "jax", n, out, devices=n))
        procs += [spawn(__file__, "rank", r, n, out / f"store{n}", out)
                  for r in range(n)]
    for n in HOOK_WORLDS:
        procs += [spawn(__file__, "hook", r, n, out / f"hookstore{n}", out)
                  for r in range(n)]
    jax_hook = finish(procs, TIMEOUT_S, while_running=jax_decodes)

    def load(kind, calls, n):
        return [(dict(np.load(out / f"{kind}{n}-{r}.npz")),
                 json.loads((out / f"{calls}{n}-{r}.json").read_text()))
                for r in range(n)]
    return {"jax": {n: dict(np.load(out / f"jax{n}.npz")) for n in WORLDS},
            "port": {n: load("port", "calls", n) for n in WORLDS},
            "hook": {n: load("hook", "hookcalls", n) for n in HOOK_WORLDS},
            "jax_hook": jax_hook}


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=msg)


KEYS = [key for key, *_ in case_keys(WORLDS[0])]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("key", KEYS)
def test_shard_matches_jax(results, n, key):
    jax_out = results["jax"][n]
    want_shard = jax_out[f"shard-{key}"]
    want_ref = jax_out[f"ref-{key}"]
    for r, (port, _) in enumerate(results["port"][n]):
        got = port[f"shard-{key}"]
        _close(got, want_shard[r], msg=f"rank {r} vs JAX shard")
        _close(got, want_ref, msg=f"rank {r} vs JAX oracle")


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("dt", DTYPES)
def test_oracle_matches_jax(results, n, dt):
    port, _ = results["port"][n][0]
    for key, kdt, *_ in case_keys(n):
        if kdt == dt:
            _close(port[f"ref-{key}"], results["jax"][n][f"ref-{key}"],
                   msg=key)


@pytest.mark.parametrize("n", WORLDS)
def test_every_rank_ends_equal_after_three_all_reduces(results, n):
    ranks = results["port"][n]
    for port, calls in ranks:
        assert calls == [3] * len(KEYS)
        for key, val in port.items():
            np.testing.assert_array_equal(val, ranks[0][0][key], err_msg=key)


@pytest.mark.parametrize("n", WORLDS)
def test_window_tensor_equals_int(results, n):
    for port, _ in results["port"][n]:
        for key in KEYS:
            np.testing.assert_array_equal(port[f"tensor-window-{key}"],
                                          port[f"shard-{key}"])


@pytest.mark.parametrize("s", [100, 2 * 1024, 2600, 5 * 1024 + 7])
def test_pv_runs_equal_one_product(s):
    """``_pv``'s partial products over runs of ``PV_CHUNK`` keys equal
    one product within f32 rounding, tails included."""
    from repro_torch.core import flash_decode as fd
    rng = np.random.default_rng(s)
    p = torch.from_numpy(rng.random((2, 2, 3, s)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, s, 2, 16))
                         .astype(np.float32))
    want = torch.einsum("bkgs,bskd->bkgd", p.double(), v.double())
    got = fd._pv(p, v)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("n", HOOK_WORLDS)
@pytest.mark.parametrize("arch", [a for a, _ in HOOK_ARCHS])
def test_decode_hook_matches_jax(results, n, arch):
    want = results["jax_hook"]
    for r, (port, _) in enumerate(results["hook"][n]):
        for t in range(GEN):
            got = port[f"{arch}-{t}"]
            for name in ("plain", "ref"):
                _close(got, want[(name, arch, t)], rtol=HOOK_TOL,
                       atol=HOOK_TOL, msg=f"rank {r} step {t} vs JAX {name}")


@pytest.mark.parametrize("n", HOOK_WORLDS)
@pytest.mark.parametrize("arch,changes", HOOK_ARCHS)
def test_decode_hook_all_reduces(results, n, arch, changes):
    """Three a step per attention layer that takes the hook; qwen2-7b's
    padded heads fall back (none)."""
    want = 3 * attention_layers(port_config(arch, changes))
    assert (want == 0) == (arch == "qwen2-7b")
    for _, calls in results["hook"][n]:
        assert calls[arch] == [want] * GEN


@pytest.mark.parametrize("n", HOOK_WORLDS)
def test_decode_step_refuses_a_cache_that_does_not_split(results, n):
    for _, calls in results["hook"][n]:
        assert calls["odd_cache_raises"] == (n > 1)


def test_jax_decodes_with_and_without_the_oracle_hook_agree(results):
    want = results["jax_hook"]
    for arch, _ in HOOK_ARCHS:
        for t in range(GEN):
            _close(want[("ref", arch, t)], want[("plain", arch, t)],
                   rtol=HOOK_TOL, atol=HOOK_TOL, msg=f"{arch} step {t}")


if __name__ == "__main__":
    torch.set_num_threads(1)
    mode, args = sys.argv[1], sys.argv[2:]
    if mode == "jax":
        jax_main(int(args[0]), args[1])
    else:
        {"rank": rank_main, "hook": hook_main}[mode](
            int(args[0]), int(args[1]), args[2], args[3])
