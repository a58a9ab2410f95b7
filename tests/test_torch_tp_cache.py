"""The decode cache of the tensor-parallel serving steps, block by
block, on ``gloo`` ranks in subprocesses (this file is also the program
of its ranks).

The meshes of ``test_torch_tp_serve.py`` -- (data 1, model 2), (data 2,
model 2), (data 1, model 3) -- each spawned once, and on (2, 2) also a
batch of 1, which does not split over the data axis, so the JAX
package's rule gives the sequence every axis.  Every rank serves the ten
smoke configs at ``cfg.with_tp(M)`` in f32 (a prefill of 6 tokens into a
cache of 12, then 3 decode steps, the default ``seq_parallel``), and
after the prefill and after the decodes each of its cache blocks --
K/V and the MLA latent by batch rows and sequence, the Mamba state by
heads and ``conv_x`` by channels over ``model`` (``lm.cache_specs``) --
must equal the matching block of the unsharded path's cache at the same
config within 1e-5 (the K/V of later layers come from hidden states
summed over ranks, whose order differs from the unsharded product's).
The Mamba archs at M = 3 are refused (their 128 d_inner channels and
8 heads do not split evenly over 3, where JAX's ``device_put`` refuses
them too), by ``make_cache`` and by the steps.
"""

import json
import os
import sys

import numpy as np
import pytest

from _ranks import finish, gloo_rank, spawn

MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x3": (1, 3)}
ARCHS = ("llama3.2-1b", "gemma2-9b", "qwen2-7b", "qwen2-vl-7b",
         "musicgen-medium", "granite-moe-3b-a800m", "moonshot-v1-16b-a3b",
         "minicpm3-4b", "mamba2-780m", "hymba-1.5b")
# (mesh, batch): batch 2 splits over the data axis of (2, 2); batch 1
# does not, and the sequence takes every axis
LAYOUTS = (("1x2", 2), ("2x2", 2), ("2x2", 1), ("1x3", 2))
PROMPT, SEQ, GEN = 6, 12, 3
TOL = 1e-5
TIMEOUT_S = 300


def port_config(arch, m):
    from repro_torch.configs import get_smoke_config
    return get_smoke_config(arch).with_tp(m)


def mamba_refused(arch, m) -> bool:
    cfg = port_config(arch, 1)
    return cfg.mamba is not None and cfg.mamba.n_heads(cfg.d_model) % m != 0


def inputs(cfg, arch, batch):
    rng = np.random.default_rng(sum(map(ord, arch)) + batch)
    if cfg.frontend == "audio_stub":
        d = cfg.d_model
        return ({"embeds": rng.standard_normal((batch, PROMPT, d))
                 .astype(np.float32)},
                [{"embeds": rng.standard_normal((batch, 1, d))
                  .astype(np.float32)} for _ in range(GEN)])
    return ({"tokens": rng.integers(0, cfg.vocab, (batch, PROMPT))
             .astype(np.int32)},
            [{"tokens": rng.integers(0, cfg.vocab, (batch,))
              .astype(np.int32)} for _ in range(GEN)])


def _blocks_diff(cache, whole, shardings, mesh):
    """Per entry: (this rank's block shape, max |block - the matching
    block of the whole cache|)."""
    from repro_torch.launch.mesh import local_slices
    out = {}
    for k, sh in shardings.items():
        mine = cache[k].to_local()
        want = whole[k][local_slices(whole[k].shape, sh.spec, mesh)]
        out[k] = (list(mine.shape), float((mine - want).abs().max())
                  if mine.shape == want.shape else float("inf"))
    return out


def rank_main(name: str, rank: int, n: int, store_path: str,
              out_dir: str) -> None:
    import torch
    from repro_torch import serve
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import convert
    torch.set_num_threads(1)
    dist = gloo_rank(rank, n, store_path)
    shape = MESHES[name]
    m = shape[1]
    report = {}
    try:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        scfg = steps.StepConfig(param_dtype="float32", cache_dtype="float32")
        for (lay_name, b) in LAYOUTS:
            if lay_name != name:
                continue
            for arch in ARCHS:
                key = f"{name}-b{b}-{arch}"
                cfg = port_config(arch, m)
                if mamba_refused(arch, m):
                    msgs = []
                    for call in (lambda: steps.make_cache(
                            cfg, scfg, batch=b, max_len=SEQ, device="cpu",
                            mesh=mesh), lambda: steps.make_decode_step(
                            cfg, scfg, seq_len=SEQ, batch=b, device="cpu",
                            mesh=mesh)):
                        try:
                            call()
                            msgs.append("no error")
                        except (ValueError, NotImplementedError) as e:
                            msgs.append(f"{type(e).__name__}: {e}")
                    report[key] = msgs
                    continue
                full = serve.build_model(cfg, 0, "cpu")
                local = convert.tp_shard_model(full, cfg, mesh)
                x, feed = inputs(cfg, arch, b)
                runs = {}
                for mesh_ in (None, mesh):
                    model = full if mesh_ is None else local
                    pre = steps.make_prefill_step(
                        cfg, scfg, seq_len=PROMPT, batch=b, device="cpu",
                        mesh=mesh_)
                    dec = steps.make_decode_step(
                        cfg, scfg, seq_len=SEQ, batch=b, device="cpu",
                        mesh=mesh_)
                    cache = steps.make_cache(cfg, scfg, batch=b,
                                             max_len=SEQ, device="cpu",
                                             mesh=mesh_)
                    bt = {k: torch.from_numpy(v) for k, v in x.items()}
                    _, cache = pre(model, bt, cache)
                    snaps = [{k: t.to_local().clone() if mesh_ is not None
                              else t.clone() for k, t in cache.items()}]
                    for t, f in enumerate(feed):
                        tok = torch.from_numpy(f["tokens"]) \
                            if "tokens" in f else None
                        emb = torch.from_numpy(f["embeds"]) \
                            if "embeds" in f else None
                        _, cache = dec(model, cache, tok, PROMPT + t,
                                       embeds=emb)
                    runs[mesh_ is None] = (snaps[0], cache)
                whole_pre, whole = runs[True]
                pre_local, cache = runs[False]
                shardings = steps._cache_shardings(cfg, mesh, b)
                report[key] = {
                    "prefill": {k: [list(pre_local[k].shape), float(
                        (pre_local[k] - whole_pre[k][
                            _slices(whole_pre[k], shardings[k], mesh)])
                        .abs().max())] for k in shardings},
                    "decode": _blocks_diff(cache, whole, shardings, mesh),
                    "whole": {k: list(t.shape) for k, t in whole.items()},
                }
    finally:
        with open(os.path.join(out_dir, f"{name}-rank{rank}.json"),
                  "w") as fh:
            json.dump(report, fh)
        dist.destroy_process_group()


def _slices(t, sharding, mesh):
    from repro_torch.launch.mesh import local_slices
    return local_slices(t.shape, sharding.spec, mesh)


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_cache")
    procs = []
    for name, (dp, m) in MESHES.items():
        n = dp * m
        procs += [spawn(__file__, name, r, n, out / f"{name}-store", out)
                  for r in range(n)]
    finish(procs, TIMEOUT_S)
    return {name: [json.loads((out / f"{name}-rank{r}.json").read_text())
                   for r in range(dp * m)]
            for name, (dp, m) in MESHES.items()}


CASES = [(name, b, arch, phase) for name, b in LAYOUTS for arch in ARCHS
         if not mamba_refused(arch, MESHES[name][1])
         for phase in ("prefill", "decode")]


def _block_shape(whole, name, b, key, rank):
    """The block of a whole cache entry a rank holds by the rule of
    ``steps._cache_axes`` and ``lm.cache_specs``."""
    dp, m = MESHES[name]
    d_idx, m_idx = divmod(rank, m)
    shape = list(whole)
    batch_split = b % dp == 0 and b >= dp
    if key in ("k", "v", "ckv", "kr"):
        if batch_split:
            shape[1] //= dp
            shape[2] //= m
        else:
            shape[2] //= dp * m
    elif key in ("state", "conv_x", "conv_B", "conv_C"):
        if batch_split:
            shape[1] //= dp
        if key in ("state", "conv_x"):
            shape[2 if key == "state" else 3] //= m
    return shape


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{n}-b{b}-{a}-{p}" for n, b, a, p in CASES])
def test_each_rank_holds_its_block_of_the_unsharded_cache(reports, case):
    name, b, arch, phase = case
    for rank, rep in enumerate(reports[name]):
        r = rep[f"{name}-b{b}-{arch}"]
        assert set(r[phase]) == set(r["whole"])
        for key, (shape, diff) in r[phase].items():
            assert shape == _block_shape(r["whole"][key], name, b, key,
                                         rank), (key, shape)
            assert diff <= TOL, (rank, key, diff)


@pytest.mark.parametrize("arch", [a for a in ARCHS if mamba_refused(a, 3)])
def test_mamba_at_three_model_ranks_is_refused(reports, arch):
    for rep in reports["1x3"]:
        make_cache, step = rep[f"1x3-b2-{arch}"]
        assert make_cache.startswith("ValueError") and \
            "not divisible by 3" in make_cache
        assert step.startswith("NotImplementedError") and \
            "do not split evenly over 3 model ranks" in step


if __name__ == "__main__":
    rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
              sys.argv[5])
