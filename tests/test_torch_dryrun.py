"""The port's dry run (``launch/dryrun.py``) and what it reads, against
the JAX package's arithmetic and against real steps (this file is also
the program of its subprocesses).

The JAX package's own dry run does not lower here (its mini dry run,
``test_engine_multidev.py::test_launch_steps_mini_dryrun``, fails on
this jax; ROADMAP queue 3), and neither does its ``make_prefill_step``
on a one-device mesh.  So the port's dry run is held to:

  * the reference's shapes, parameter counts, ``MODEL_FLOPS`` and
    rank-0 parameter blocks at ``with_tp(16)``;
  * JAX's HLO of the unsharded jitted ``lm.prefill`` on one device: a
    smoke prefill traced on a (1, 1) mesh has exactly its
    ``hlo_analysis`` dot FLOPs (the same products; flash counted as the
    two dots of masked attention, 4·B·H·Sq·Sk·D);
  * real steps: the mini cells of ``check_launch_steps.py`` (smoke
    llama3.2-1b, granite-moe-3b-a800m and mamba2-780m, seq 64, global
    batch 4, f32) traced on a fake (2, 2) mesh and run on 4 gloo ranks
    of a real (2, 2) mesh: rank 0's ``compat.CALLS`` and
    ``FlopCounterMode`` total equal the dry run's exactly.

Two subprocesses each hold a fake group of 256 ranks: one the mini dry
run on a fake (2, 4) mesh (train, prefill, decode with flash decode on
and off but for mamba; the bulk and per_leaf syncs), the other the
(2, 2) and (1, 1) traces, the collective bytes by dtype, the parameter
blocks at (16, 16), a mesh made twice, and one production cell
(llama3.2-1b x decode_32k x single) through the CLI.
"""

import dataclasses
import gc
import json
import os
import sys
import warnings

import numpy as np
import pytest

from _ranks import finish, gloo_rank, spawn

MINI_ARCHS = ("llama3.2-1b", "granite-moe-3b-a800m", "mamba2-780m")
SEQ, BATCH = 64, 4
TIMEOUT_S = 300
# the keys benchmarks.roofline_report and experiments_tables read
READ_KEYS = {"arch", "shape", "mesh", "trace_s", "memory", "cost",
             "collectives", "roofline"}
READ_MEMORY = {"total_per_device_gib", "fits_80gb"}
READ_ROOFLINE = {"compute_s", "memory_s", "collective_s", "dominant",
                 "useful_compute_ratio"}


def variants(arch):
    """(kind, flash decode) of each mini cell (check_launch_steps.py)."""
    out = [("train", False), ("prefill", False), ("decode", False)]
    if arch != "mamba2-780m":
        out.append(("decode", True))
    return out


def vkey(arch, kind, fd):
    return f"{arch}-{kind}-fd{int(fd)}"


def mini_shape(kind):
    from repro_torch.configs.shapes import ShapeConfig
    return ShapeConfig(f"mini_{kind}", kind, SEQ, BATCH)


def mini_scfg(fd):
    from repro_torch.launch.steps import StepConfig
    return StepConfig(param_dtype="float32", flash_decode=fd)


def _calls_delta(compat, before):
    return {k: compat.CALLS[k] - before[k] for k in before}


def _collective_cases(torch, compat, groups):
    """Each collective through ``compat`` once, on tensors of three
    dtypes: (name, CALLS delta, the result's bytes)."""
    out = []
    model, world = groups
    cases = [
        ("all_reduce", lambda: compat.psum_(torch.ones(8, 4), world)),
        ("all_gather", lambda: compat.all_gather_(
            torch.ones(3, 5, dtype=torch.bfloat16), 0, world)),
        ("all_gather_dim1", lambda: compat.all_gather_(
            torch.ones(2, 3, dtype=torch.bfloat16), 1, model)),
        ("reduce_scatter", lambda: compat.reduce_scatter_(
            torch.ones(8, 3), 0, world)),
        ("reduce_scatter_bf16", lambda: compat.reduce_scatter_(
            torch.ones(2, 4, dtype=torch.bfloat16), 1, model)),
        ("ppermute", lambda: compat.ppermute(
            torch.ones(5, dtype=torch.int8), model, [(0, 1), (1, 0)])),
    ]
    for name, fn in cases:
        before = dict(compat.CALLS)
        res = fn()
        out.append((name, _calls_delta(compat, before),
                    res.numel() * res.element_size()))
    return out


def dry_main(part: str, out_dir: str) -> None:
    """The fake group of 256 ranks: the dry-run cases of the tests, in
    two processes (``part``): the mini dry run on (2, 4), and the
    rest."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import compat
    from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as pmesh
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.models import lm
    torch.set_num_threads(1)
    # no code on the path may read a fake tensor's address
    warnings.filterwarnings("error", ".*data pointer of FakeTensor")
    dryrun.fake_world(256)
    if part == "mini":
        rep = {"mini": {
            vkey(arch, kind, fd): dryrun.analyze_cell(
                arch, mini_shape(kind), mesh_shape=(2, 4),
                scfg=mini_scfg(fd), cfg=get_smoke_config(arch))
            for arch in MINI_ARCHS for kind, fd in variants(arch)}}
        rep["sync"] = {
            mode: dryrun.analyze_cell(
                "llama3.2-1b", mini_shape("train"), mesh_shape=(2, 4),
                scfg=dataclasses.replace(mini_scfg(False), sync_mode=mode),
                cfg=get_smoke_config("llama3.2-1b"))["collectives"]
            for mode in ("bulk", "per_leaf")}
        with open(os.path.join(out_dir, "mini.json"), "w") as fh:
            json.dump(rep, fh)
        return
    rep = {"2x2": {}, "1x1": {}, "blocks": {}}
    for arch in MINI_ARCHS:
        cfg = get_smoke_config(arch)
        for kind, fd in variants(arch):
            rep["2x2"][vkey(arch, kind, fd)] = dryrun.analyze_cell(
                arch, mini_shape(kind), mesh_shape=(2, 2),
                scfg=mini_scfg(fd), cfg=cfg)
        rep["1x1"][arch] = dryrun.analyze_cell(
            arch, mini_shape("prefill"), mesh_shape=(1, 1),
            scfg=dataclasses.replace(mini_scfg(False),
                                     cache_dtype="float32"), cfg=cfg)
    dev = dryrun.trace_device()
    m22 = pmesh.make_mesh((2, 2), ("data", "model"), dev)
    for arch in MINI_ARCHS:
        c = get_smoke_config(arch).replace(param_dtype="float32").with_tp(2)
        rep["2x2"][f"{arch}-local"] = {
            k: list(v) for k, v in lm.local_shapes(
                c, lm.param_blocks(c, m22)).items()}
    # a second mesh of the same layout keeps its groups when the first
    # one goes (DeviceMesh equality is by layout)
    again = pmesh.make_mesh((2, 2), ("data", "model"), dev)
    del m22
    gc.collect()
    rep["mesh_again"] = pmesh.axis_group(again, "model") is not None
    m16 = pmesh.make_mesh((16, 16), ("data", "model"), dev)
    for arch in ARCH_IDS:
        c = get_config(arch).with_tp(16)
        rep["blocks"][arch] = {
            k: [s.stop - s.start for s in sl]
            for k, sl in lm.param_blocks(c, m16).items()}
    groups = (pmesh.axis_group(again, "model"),
              pmesh.axis_group(again, ("data", "model")))
    with FakeTensorMode():
        with OpAnalysis() as a:
            rep["collectives"] = _collective_cases(torch, compat, groups)
    rep["collective_stats"] = a.stats.to_dict()
    try:
        dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                     "--mesh", "single", "--out", out_dir])
    except SystemExit as e:
        rep["cli_exit"] = e.code
    with open(os.path.join(out_dir, "dry.json"), "w") as fh:
        json.dump(rep, fh)


def _fill(torch, cfg, parts, seed):
    """Values for the empty tensors of ``dryrun.cell_call``: small
    normal weights, tokens and labels in the vocabulary, embeddings;
    the cache and the moments stay zero."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in parts["params"].parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.02)
        for k, t in parts["batch"].items():
            if t.dtype == torch.int32:
                t.copy_(torch.randint(0, cfg.vocab, t.shape, generator=g))
            else:
                t.copy_(torch.randn(t.shape, generator=g))


def rank_main(rank: int, n: int, store: str, out_dir: str) -> None:
    """A rank of the real (2, 2) mesh: the mini cells' steps on the
    values of :func:`_fill`, their CALLS and FLOPs; the collectives of
    :func:`_collective_cases` on real tensors."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import compat
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as pmesh
    from repro_torch.launch.op_analysis import argument_bytes
    torch.set_num_threads(1)
    dist = gloo_rank(rank, n, store)
    rep = {}
    try:
        mesh = pmesh.make_mesh((2, 2), ("data", "model"), "cpu")
        dev = torch.device("cpu")
        for arch in MINI_ARCHS:
            cfg = get_smoke_config(arch)
            for kind, fd in variants(arch):
                step, args, kw, parts = dryrun.cell_call(
                    arch, mini_shape(kind), mesh, mini_scfg(fd), dev, cfg)
                _fill(torch, cfg, parts, 0)
                before = dict(compat.CALLS)
                with FlopCounterMode(display=False) as fc:
                    step(*args, **kw)
                rep[vkey(arch, kind, fd)] = {
                    "calls": _calls_delta(compat, before),
                    "flops": fc.get_total_flops(),
                    "params_bytes": argument_bytes(parts["params"])}
        groups = (pmesh.axis_group(mesh, "model"),
                  pmesh.axis_group(mesh, ("data", "model")))
        rep["collectives"] = _collective_cases(torch, compat, groups)
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(rep, fh)
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    procs = [spawn(__file__, "dry", part, out) for part in ("mini", "rest")]
    store = str(out / "store")
    procs += [spawn(__file__, "rank", r, 4, store, out) for r in range(4)]
    finish(procs, TIMEOUT_S)
    dry = json.loads((out / "dry.json").read_text())
    dry.update(json.loads((out / "mini.json").read_text()))
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(4)]
    return dry, ranks, out


# ---------------------------------------------------------------------------
# The reference's arithmetic (in this process)
# ---------------------------------------------------------------------------

ARCH_IDS = ("hymba-1.5b", "granite-moe-3b-a800m", "moonshot-v1-16b-a3b",
            "gemma2-9b", "qwen2-7b", "llama3.2-1b", "minicpm3-4b",
            "musicgen-medium", "mamba2-780m", "qwen2-vl-7b")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_and_cells_equal_reference(arch):
    from repro.configs import shapes as jshapes
    from repro_torch.configs import shapes
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    assert shapes.LONG_CONTEXT_ARCHS == jshapes.LONG_CONTEXT_ARCHS
    assert [s.name for s in shapes.cells(arch)] == \
        [s.name for s in jshapes.cells(arch)]


def test_thirty_three_production_cells():
    from repro_torch.configs import ARCH_IDS as PORT_ARCHS
    from repro_torch.configs.shapes import cells
    assert set(PORT_ARCHS) == set(ARCH_IDS)
    assert sum(len(cells(a)) for a in PORT_ARCHS) == 33


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_equal_jax(arch, smoke):
    from repro import configs as jconfigs
    from repro_torch import configs
    get = "get_smoke_config" if smoke else "get_config"
    for tp in (1, 16):
        c = getattr(configs, get)(arch).with_tp(tp)
        j = getattr(jconfigs, get)(arch).with_tp(tp)
        assert c.param_count() == j.param_count()
        assert c.param_count(padded=True) == j.param_count(padded=True)
        assert c.active_param_count() == j.active_param_count()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_jax(arch):
    """6·N·D to train, 2·N·D to serve, N = JAX's active parameters."""
    from repro import configs as jconfigs
    from repro_torch.configs.shapes import cells
    from repro_torch.launch import dryrun
    n = jconfigs.get_config(arch).active_param_count()
    for shape in cells(arch):
        tokens = shape.global_batch * (shape.seq_len
                                       if shape.kind != "decode" else 1)
        want = (6 if shape.kind == "train" else 2) * n * tokens
        assert dryrun.model_flops(arch, shape) == want


# ---------------------------------------------------------------------------
# The dry run (one subprocess) against JAX and against gloo ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rank0_parameter_blocks_at_tp16_equal_jax(results, arch):
    """Rank 0's block of every leaf on the 16x16 mesh equals the block
    JAX's ``lm.param_specs`` gives at ``with_tp(16)``, the leaf's dims
    split over the 16 ``model`` ranks (computed without lowering).  The
    JAX tree is built at two layers (its MoE inits take seconds a
    layer), whose per-layer shapes are the config's; the stacked layer
    axis is then the config's L."""
    from repro import configs as jconfigs
    from repro.models import lm as jlm
    dry, _, _ = results
    jc = jconfigs.get_config(arch).with_tp(16)
    shapes = jlm.param_shapes(jc.replace(n_layers=2))
    specs = jlm.param_specs(jc)
    flat_specs = dict(_dotted(specs, leaf=_is_spec))
    want = {}
    for k, s in _dotted(shapes):
        shape = list(s.shape)
        if k.startswith("layers."):
            shape[0] = jc.n_layers
        spec = tuple(flat_specs[k]) + (None,) * (len(shape)
                                                 - len(flat_specs[k]))
        assert all(e is None or shape[d] % 16 == 0
                   for d, e in enumerate(spec)), (k, shape, spec)
        want[k] = [n // 16 if e is not None else n
                   for n, e in zip(shape, spec)]
    assert dry["blocks"][arch] == want


def _is_spec(x):
    from jax.sharding import PartitionSpec
    return isinstance(x, PartitionSpec)


def _dotted(tree, prefix="", leaf=None):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict) and not (leaf and leaf(v)):
            yield from _dotted(v, f"{prefix}{k}.", leaf)
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", MINI_ARCHS)
def test_mini_dry_run_mirrors_check_launch_steps(results, arch, tmp_path,
                                                 monkeypatch):
    """``check_launch_steps.py``'s assertions on the fake (2, 4) mesh:
    the train step all-reduces, has dot FLOPs, HBM traffic and
    temporaries; prefill and decode (flash decode on and off) trace;
    and the records carry the keys the report and the tables read."""
    from repro_torch.benchmarks import experiments_tables, roofline_report
    dry, _, _ = results
    recs = {k: v for k, v in dry["mini"].items() if k.startswith(arch)}
    assert sorted(recs) == sorted(vkey(arch, k, f)
                                  for k, f in variants(arch))
    train = recs[vkey(arch, "train", False)]
    assert train["collectives"]["counts"]["all-reduce"] > 0
    assert train["cost"]["flops_per_device"] > 0
    assert train["cost"]["bytes_per_device"] > 0
    assert train["memory"]["temp_bytes"] > 0
    for k, rec in recs.items():
        assert READ_KEYS <= set(rec), k
        assert READ_MEMORY <= set(rec["memory"]), k
        assert READ_ROOFLINE <= set(rec["roofline"]), k
        assert rec["mesh"] == "2x4" and rec["n_chips"] == 8
        assert 0 < rec["cost"]["bytes_per_device"] \
            <= rec["cost"]["bytes_per_device_upper_bound"]
    # the report and the tables read them (named as production cells)
    monkeypatch.setattr(roofline_report, "ART", tmp_path)
    for kind, name in (("train", "train_4k"), ("prefill", "prefill_32k"),
                       ("decode", "decode_32k")):
        rec = dict(recs[vkey(arch, kind, False)], shape=name)
        (tmp_path / f"{arch}__{name}__single.json").write_text(
            json.dumps(rec))
    rows = roofline_report.rows()
    assert [r[0] for r in rows] == [f"roofline/{arch}/{s}/2x4" for s in
                                    ("decode_32k", "prefill_32k",
                                     "train_4k")]
    experiments_tables.dryrun_table("single")
    experiments_tables.roofline_table("single")


def test_every_sync_mode_traces(results):
    """The bulk and per_leaf syncs (whose layer hooks gather each
    stacked leaf's gradients by tensor identity) trace too: the same
    forward and backward collectives as partitioned, and one all-reduce
    a bucket, per_leaf's buckets a leaf each, the most of the three."""
    dry, _, _ = results
    part = dry["mini"][vkey("llama3.2-1b", "train", False)]["collectives"]
    bulk, per_leaf = dry["sync"]["bulk"], dry["sync"]["per_leaf"]
    for c in (bulk, per_leaf):
        assert {k: v for k, v in c["counts"].items() if k != "all-reduce"} \
            == {k: v for k, v in part["counts"].items()
                if k != "all-reduce"}
    assert 0 < bulk["counts"]["all-reduce"] \
        <= part["counts"]["all-reduce"] < per_leaf["counts"]["all-reduce"]


def test_prefill_dot_flops_equal_jax_hlo(results):
    """A smoke prefill traced on a (1, 1) mesh has exactly the dot FLOPs
    ``hlo_analysis`` finds in the HLO of JAX's jitted unsharded
    ``lm.prefill`` (f32, one device): the same products, the flash
    kernel counted as masked attention's two dots over every (query,
    key) pair.  No tolerance: both count 2·m·n·k per product."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config
    from repro.launch import hlo_analysis
    from repro.models import lm as jlm
    dry, _, _ = results
    for arch in MINI_ARCHS:
        jc = get_smoke_config(arch).replace(param_dtype="float32")
        params = jax.eval_shape(lambda: jlm.init_params(
            jc, jax.random.PRNGKey(0)))
        batch = {"tokens": jax.ShapeDtypeStruct((BATCH, SEQ), jnp.int32)}
        cache = jax.eval_shape(lambda: jlm.init_cache(jc, BATCH, SEQ,
                                                      jnp.float32))
        hlo = jax.jit(lambda p, b, c: jlm.prefill(jc, p, b, cache=c)).lower(
            params, batch, cache).compile().as_text()
        assert dry["1x1"][arch]["cost"]["flops_per_device"] == \
            hlo_analysis.analyze_hlo(hlo).dot_flops, arch


@pytest.mark.parametrize("arch", MINI_ARCHS)
def test_dry_run_equals_gloo_ranks(results, arch):
    """Rank 0 of a real (2, 2) mesh of gloo ranks runs each mini cell:
    its ``compat.CALLS`` counts and bytes by type and its
    ``FlopCounterMode`` total equal the dry run's on the fake (2, 2)
    mesh exactly, and its parameters' bytes equal both the dry run's
    and the bytes of ``lm.param_blocks``' local shapes."""
    from repro_torch.launch.op_analysis import alloc_bytes
    dry, ranks, _ = results
    local = dry["2x2"][f"{arch}-local"]
    want_params = sum(alloc_bytes(4 * int(np.prod(s)))
                      for s in local.values())
    kinds = {"all_reduce": "all-reduce", "all_gather": "all-gather",
             "reduce_scatter": "reduce-scatter",
             "ppermute": "collective-permute"}
    for kind, fd in variants(arch):
        key = vkey(arch, kind, fd)
        rec, real = dry["2x2"][key], ranks[0][key]
        assert real["flops"] == rec["cost"]["flops_per_device"], key
        counts = rec["collectives"]["counts"]
        nbytes = rec["collectives"]["bytes"]
        for call, k in kinds.items():
            assert real["calls"][call] == counts.get(k, 0), (key, call)
            assert real["calls"][f"{call}_bytes"] == nbytes.get(k, 0), \
                (key, call)
        assert real["params_bytes"] == rec["memory"]["params_bytes"] \
            == want_params, key


def test_a_mesh_made_again_keeps_its_groups(results):
    """``launch.mesh`` keeps each mesh's flat groups by mesh, and a
    DeviceMesh equals another of the same layout: a second (2, 2) mesh
    made while the first lives keeps its groups once the first goes."""
    dry, _, _ = results
    assert dry["mesh_again"] is True


def test_collective_bytes_are_result_bytes(results):
    """Each collective counts once and by the bytes of its result on
    this rank, whatever its dtype: on the fake group (the dry run) and
    on gloo ranks alike, where the result is real; the all-reduce's
    bytes are its input's, as before, and every earlier count stays."""
    dry, ranks, _ = results
    for rep in [dry["collectives"]] + [r["collectives"] for r in ranks]:
        for name, delta, res_bytes in rep:
            call = name.split("_dim")[0].replace("_bf16", "")
            assert delta[call] == 1, name
            assert delta[f"{call}_bytes"] == res_bytes, name
            assert sum(v for k, v in delta.items()
                       if not k.startswith(call)) == 0, name
    want = {name: b for name, _, b in dry["collectives"]}
    assert want == {"all_reduce": 128, "all_gather": 4 * 30,
                    "all_gather_dim1": 2 * 12, "reduce_scatter": 2 * 12,
                    "reduce_scatter_bf16": 2 * 4, "ppermute": 5}
    stats = dry["collective_stats"]
    assert stats["counts"] == {"all-reduce": 1, "all-gather": 2,
                               "reduce-scatter": 2,
                               "collective-permute": 1}
    assert stats["total_bytes"] == sum(want.values())


def test_production_cell_through_the_cli(results):
    """llama3.2-1b x decode_32k on the fake 16x16 mesh: the reference's
    tag and keys; 2 all-reduces a layer and one for the embedding, the
    K and V gathers of the sequence-split cache (2 a layer) and the
    logits' gather; 2·N·B model FLOPs."""
    from repro import configs as jconfigs
    dry, _, out = results
    assert dry["cli_exit"] == 0
    rec = json.loads((out / "llama3.2-1b__decode_32k__single.json")
                     .read_text())
    assert READ_KEYS <= set(rec)
    assert (rec["mesh"], rec["n_chips"]) == ("16x16", 256)
    L = jconfigs.get_config("llama3.2-1b").n_layers
    assert rec["collectives"]["counts"] == {"all-reduce": 2 * L + 1,
                                            "all-gather": 2 * L + 1}
    n = jconfigs.get_config("llama3.2-1b").active_param_count()
    assert rec["roofline"]["model_flops_global"] == 2 * n * 128
    assert rec["memory"]["fits_80gb"]
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")


# ---------------------------------------------------------------------------
# The kernels' routes
# ---------------------------------------------------------------------------

def test_real_cpu_tensors_take_the_plain_route(monkeypatch):
    """A CPU tensor through ``ops.flash_attention`` and
    ``bucketing.pack`` / ``unpack`` takes the plain versions as before,
    not the fake route, and launches nothing; a FakeTensor takes the
    fake route and no plain version."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import bucketing
    from repro_torch.kernels import bucket_pack as bp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    seen = []

    def spy(name, fn):
        def wrapped(*a, **k):
            seen.append(name)
            return fn(*a, **k)
        monkeypatch.setattr(bp if "bucket" in name else fa, name, wrapped)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 16, 8, generator=g)
    want = fa.flash_attention_plain(q, q, q)
    for name, mod in (("flash_attention_plain", fa),
                      ("bucket_pack_plain", bp),
                      ("bucket_unpack_plain", bp)):
        spy(name, getattr(mod, name))
    launches = (dict(fa.LAUNCHES), dict(bp.LAUNCHES))
    assert torch.equal(ops.flash_attention(q, q, q), want)
    leaves = [torch.randn(3, 4, generator=g), torch.randn(5, generator=g)]
    plan = bucketing.make_plan(leaves, 1 << 20)
    flat = bucketing.pack(leaves, plan.buckets[0])
    assert torch.equal(flat, torch.cat([t.reshape(-1) for t in leaves]))
    back = bucketing.unpack(flat, plan.buckets[0], leaves)
    assert all(torch.equal(a[0], b) for a, b in zip(back, leaves))
    assert seen == ["flash_attention_plain", "bucket_pack_plain",
                    "bucket_unpack_plain"]
    assert (dict(fa.LAUNCHES), dict(bp.LAUNCHES)) == launches
    seen.clear()
    with FakeTensorMode():
        q = torch.empty(1, 2, 16, 8, dtype=torch.bfloat16, device="cpu")
        assert ops.flash_attention(q, q, q).shape == q.shape
        leaves = [torch.empty(3, 4), torch.empty(5)]
        flat = bucketing.pack(leaves, plan.buckets[0])
        assert flat.shape == (17,)
        back = bucketing.unpack(flat, plan.buckets[0], leaves)
        assert [tuple(p[0].shape) for p in back] == [(3, 4), (5,)]
    assert seen == []


if __name__ == "__main__":
    if sys.argv[1] == "dry":
        dry_main(sys.argv[2], sys.argv[3])
    else:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                  sys.argv[5])
