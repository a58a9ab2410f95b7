"""The sequence-sharded decode cache on the port's mesh, on 4 ``gloo``
ranks in subprocesses (this file is also the rank's program).

A ``(4, 1)`` mesh and a batch of 2, which does not split over the 4
data-parallel ranks, so the JAX package's rule gives every axis to the
sequence: each rank holds 4 of the cache's 16 positions.  On the smoke
configs of llama3.2-1b and gemma2-9b (alternating window 8, wider than
a rank's slice, and softcap) in f32, a prefill of 3 and of 8 tokens and
8 teacher-forced decode steps after each, so the decode positions fall
on both edges of every slice (3, 4, 7, 8, 11, 12 and 15):

  * every rank's cache blocks are (L, 2, 4, Kv, D), and gathered they
    equal bit for bit the replicated cache of the plain process-group
    path (``make_decode_step(..., group=)``, every rank holding the
    whole cache);
  * the prefill and decode logits equal that path's bit for bit, on
    every rank;
  * they meet JAX's single-device ``lm.prefill`` / ``lm.decode_step``
    within 1e-4 (the tolerance of ``tests/test_torch_flash_decode.py``
    in f32).

With a batch of 4 the rule splits the batch instead: each rank holds one
row of the whole sequence, the logits are gathered from the rows, and
they and the cache meet the replicated path within 1e-5 (one row's
products round apart from four rows') and JAX within 1e-4.  A cache that
is not placed by the rule is refused; the serving steps take an MLA
config, a sequence split without flash decode and a model axis of 2,
and the train step a model axis of 2
(``tests/test_torch_tp_serve.py`` holds what they compute).
"""

import json
import os
import sys

import numpy as np
import pytest

from _ranks import finish, gloo_rank, spawn

N = 4
SEQ = 16
PROMPTS = (3, 8)
GEN = 8
ARCHS = ("llama3.2-1b", "gemma2-9b")
# (name, batch): the batch does not split over 4 ranks -> sequence
# split; it does -> batch split
LAYOUTS = (("seq", 2), ("batch", 4))
TOL = 1e-4
ROWS_TOL = 1e-5
TIMEOUT_S = 180


def port_config(arch):
    from repro_torch.configs import get_smoke_config
    return get_smoke_config(arch)


def tokens(vocab: int, batch: int, prompt: int):
    rng = np.random.default_rng(100 + prompt + batch)
    return (rng.integers(0, vocab, (batch, prompt)).astype(np.int32),
            rng.integers(0, vocab, (GEN, batch)).astype(np.int32))


def cases():
    return [(layout, b, arch, prompt) for layout, b in LAYOUTS
            for arch in ARCHS for prompt in PROMPTS
            if layout == "seq" or arch == ARCHS[0]]


def rank_main(rank: int, n: int, store_path: str, out_dir: str) -> None:
    import torch
    from repro_torch import serve
    from repro_torch.launch import steps as psteps
    from repro_torch.launch.mesh import make_mesh
    dist = gloo_rank(rank, n, store_path)
    report, logits = {}, {}
    try:
        mesh = make_mesh((n, 1), ("data", "model"), "cpu")
        scfg = psteps.StepConfig(param_dtype="float32",
                                 cache_dtype="float32", flash_decode=True)
        for layout, b, arch, prompt in cases():
            key = f"{layout}-{arch}-{prompt}"
            cfg = port_config(arch)
            model = serve.build_model(cfg, 0, "cpu")
            pr, feed = tokens(cfg.vocab, b, prompt)
            pre_m = psteps.make_prefill_step(cfg, scfg, seq_len=prompt,
                                             batch=b, device="cpu",
                                             mesh=mesh)
            dec_m = psteps.make_decode_step(cfg, scfg, seq_len=SEQ, batch=b,
                                            device="cpu", mesh=mesh)
            pre_r = psteps.make_prefill_step(cfg, scfg, seq_len=prompt,
                                             batch=b, device="cpu")
            dec_r = psteps.make_decode_step(cfg, scfg, seq_len=SEQ, batch=b,
                                            device="cpu")
            cm = psteps.make_cache(cfg, scfg, batch=b, max_len=SEQ,
                                   device="cpu", mesh=mesh)
            cr = psteps.make_cache(cfg, scfg, batch=b, max_len=SEQ,
                                   device="cpu")
            x = {"tokens": torch.from_numpy(pr)}
            lm_, cm = pre_m(model, x, cm)
            lr_, _ = pre_r(model, x, cr)
            got, want = [lm_], [lr_]
            for t in range(GEN):
                tok = torch.from_numpy(feed[t])
                lm_, cm = dec_m(model, cm, tok, prompt + t)
                lr_, cr = dec_r(model, cr, tok, prompt + t)
                got.append(lm_)
                want.append(lr_)
            report[key] = {
                "local": [list(t.to_local().shape) for t in cm.values()],
                "bitwise": all(torch.equal(g, w) for g, w in zip(got, want)),
                "max_diff": max(float((g - w).abs().max())
                                for g, w in zip(got, want)),
                "cache_diff": max(float((cm[k].full_tensor() - cr[k])
                                        .abs().max()) for k in cm),
            }
            logits[key] = torch.stack(got).numpy()
        cfg = port_config(ARCHS[0])
        model = serve.build_model(cfg, 0, "cpu")
        wrong = psteps.make_cache(cfg, scfg, batch=2, max_len=SEQ,
                                  device="cpu")
        step = psteps.make_decode_step(cfg, scfg, seq_len=SEQ, batch=2,
                                       device="cpu", mesh=mesh)
        zeros = torch.zeros(2, dtype=torch.int32)
        for name, call in (
                ("plain_cache", lambda: step(model, wrong, zeros, 0)),
                ("mla", lambda: psteps.make_decode_step(
                    port_config("minicpm3-4b"), scfg, seq_len=SEQ, batch=2,
                    device="cpu", mesh=mesh)),
                ("no_flash", lambda: psteps.make_prefill_step(
                    cfg, psteps.StepConfig(param_dtype="float32"),
                    seq_len=SEQ, batch=2, device="cpu", mesh=mesh))):
            try:
                call()
                report[name] = "no error"
            except (ValueError, NotImplementedError) as e:
                report[name] = f"{type(e).__name__}: {e}"
        tp = make_mesh((n // 2, 2), ("data", "model"), "cpu")
        for name, make in (("tp_prefill", psteps.make_prefill_step),
                           ("tp_train", psteps.make_train_step)):
            try:
                make(cfg, scfg, seq_len=SEQ, batch=4, device="cpu", mesh=tp)
                report[name] = "no error"
            except NotImplementedError as e:
                report[name] = str(e)
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(report, fh)
        if logits:
            np.savez(os.path.join(out_dir, f"logits{rank}.npz"), **logits)
        dist.destroy_process_group()


def jax_logits():
    """JAX's single-device prefill and decode logits of every case."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import lm as jlm
    from repro_torch import serve
    from repro_torch.models import convert
    out = {}
    for layout, b, arch, prompt in cases():
        jc = jconfigs.get_smoke_config(arch)
        model = serve.build_model(port_config(arch), 0, "cpu")
        params = jax.tree.map(jnp.asarray, convert.named_to_jax(
            dict(model.named_parameters())))
        pr, feed = tokens(jc.vocab, b, prompt)
        cache = jlm.init_cache(jc, b, SEQ, jnp.float32)
        lg, cache = jlm.prefill(jc, params, {"tokens": jnp.asarray(pr)},
                                cache=cache)
        got = [np.asarray(lg)]
        for t in range(GEN):
            lg, cache = jlm.decode_step(jc, params, cache,
                                        jnp.asarray(feed[t]),
                                        jnp.int32(prompt + t))
            got.append(np.asarray(lg))
        out[f"{layout}-{arch}-{prompt}"] = np.stack(got)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_cache")
    procs = [spawn(__file__, r, N, out / "store", out) for r in range(N)]
    want = finish(procs, TIMEOUT_S, while_running=jax_logits)
    return ([json.loads((out / f"rank{r}.json").read_text())
             for r in range(N)],
            [dict(np.load(out / f"logits{r}.npz")) for r in range(N)], want)


KEYS = [f"{layout}-{arch}-{prompt}" for layout, _, arch, prompt in cases()]


@pytest.mark.parametrize("key", [k for k in KEYS if k.startswith("seq")])
def test_each_rank_holds_a_quarter_of_the_sequence(results, key):
    reports, _, _ = results
    for rep in reports:
        for shape in rep[key]["local"]:
            assert shape[1:3] == [2, SEQ // N]
        assert rep[key]["cache_diff"] == 0.0


@pytest.mark.parametrize("key", [k for k in KEYS if k.startswith("seq")])
def test_logits_equal_the_replicated_cache_path_bitwise(results, key):
    reports, _, _ = results
    for rep in reports:
        assert rep[key]["bitwise"], rep[key]["max_diff"]


@pytest.mark.parametrize("key", [k for k in KEYS if k.startswith("batch")])
def test_batch_split_holds_one_row_each(results, key):
    reports, _, _ = results
    for rep in reports:
        for shape in rep[key]["local"]:
            assert shape[1:3] == [1, SEQ]
        assert rep[key]["cache_diff"] <= ROWS_TOL
        assert rep[key]["max_diff"] <= ROWS_TOL


@pytest.mark.parametrize("key", KEYS)
def test_logits_meet_jax_single_device(results, key):
    _, logits, want = results
    for r, got in enumerate(logits):
        np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_array_equal(got[key], logits[0][key])


def test_refusals(results):
    reports, _, _ = results
    for rep in reports:
        assert "not a DTensor placed by" in rep["plain_cache"]
        for name in ("mla", "no_flash", "tp_prefill", "tp_train"):
            assert rep[name] == "no error", rep[name]


if __name__ == "__main__":
    import torch
    torch.set_num_threads(1)
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
