"""The port's mesh layer against the JAX package's.

The spec trees are pure functions: ``lm.param_specs``, ``lm.cache_specs``
and ``optim.adamw.opt_state_specs`` (ZeRO-1 at data-parallel degrees 8
and 3, over one data axis and over ``("pod", "data")``) of all ten
architectures at full config, mapped onto JAX's paths by
``models.convert.leaves_to_jax``, equal the JAX package's leaf for leaf,
and ``lm.param_shapes`` its shapes.

The elastic scenario of ``tests/multidev_scripts/check_elastic.py``
runs on 8 ``gloo`` ranks in subprocesses (this file is also the rank's
program): a 4x2 mesh from ``plan_mesh(8, 2)``, a tree resharded onto
it, then a 3x2 mesh over six of the ranks after two leave
(``grad_accum_factor`` 2) with the same tree resharded again, an
oversized plan refused with the reference's message, ``None`` passing
through.  Every rank checks its own blocks and the gathered whole; a
split dim that does not divide evenly raises, as ``jax.device_put``
does, and so do a spec whose axes run against the mesh's order and a
production mesh larger than the world.  The flat groups over a tuple of
axes number their ranks row-major.
"""

import json
import os
import sys

import numpy as np
import pytest

from _ranks import finish, gloo_rank, spawn

WORLD = 8
TIMEOUT_S = 120
ARCHS = ("hymba-1.5b", "granite-moe-3b-a800m", "moonshot-v1-16b-a3b",
         "gemma2-9b", "qwen2-7b", "llama3.2-1b", "minicpm3-4b",
         "musicgen-medium", "mamba2-780m", "qwen2-vl-7b")


def rank_main(rank: int, n: int, store_path: str, out_dir: str) -> None:
    """One rank of the elastic scenario; writes what it saw."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import mesh as pmesh
    from repro_torch.launch.mesh import PartitionSpec as P
    from repro_torch.runtime import elastic
    dist = gloo_rank(rank, n, store_path)
    seen = {}
    try:
        plan = elastic.plan_mesh(n, 2)
        seen["plan"] = [plan.data, plan.model]
        mesh = elastic.build_mesh(plan, device="cpu")
        seen["shape"] = pmesh.axis_sizes(mesh)
        w = torch.arange(96.0).reshape(24, 4)
        params = {"w": w, "b": torch.ones(4), "slot": None}
        specs = {"w": P("data", "model"), "b": P("model"), "slot": P()}
        out = elastic.reshard(params, specs, mesh)
        seen["slot_none"] = out["slot"] is None
        seen["w_dtensor"] = isinstance(out["w"], DTensor)
        seen["w_placements"] = out["w"].placements == tuple(
            pmesh.to_placements(specs["w"], mesh, 2))
        seen["w_local"] = out["w"].to_local().tolist()
        seen["b_local"] = out["b"].to_local().tolist()
        seen["w_full"] = bool(torch.equal(out["w"].full_tensor(), w))

        # the flat group over (data, model): rank = row-major index
        g = pmesh.axis_group(mesh, ("data", "model"))
        seen["flat_rank"] = dist.get_rank(g)
        dp = pmesh.axis_group(mesh, ("data",))
        x = torch.tensor([float(rank)])
        dist.all_reduce(x, group=dp)
        seen["dp_sum"] = x.item()
        seen["dp_index"] = pmesh.axis_index(mesh, ("data",))

        small = elastic.plan_mesh(n - 2, 2, target_data=4)
        seen["small"] = [small.data, small.model, small.grad_accum_factor]
        mesh2 = elastic.build_mesh(small, ranks=range(n - 2), device="cpu")
        out2 = elastic.reshard(out, specs, mesh2)
        seen["in_mesh2"] = pmesh.in_mesh(mesh2)
        seen["mesh2_ranks"] = mesh2.mesh.flatten().tolist()
        seen["w2_local_numel"] = out2["w"].to_local().numel()
        if pmesh.in_mesh(mesh2):
            seen["w2_placements"] = out2["w"].placements == tuple(
                pmesh.to_placements(specs["w"], mesh2, 2))
            seen["w2_local"] = out2["w"].to_local().tolist()
            seen["w2_full"] = bool(torch.equal(out2["w"].full_tensor(), w))
            seen["slot2_none"] = out2["slot"] is None

        try:
            elastic.build_mesh(plan, ranks=range(n - 2), device="cpu")
            seen["oversized"] = "no error"
        except ValueError as e:
            seen["oversized"] = str(e)
        try:
            elastic.reshard({"x": torch.arange(10.0)}, {"x": P("data")},
                            mesh)
            seen["uneven"] = "no error"
        except ValueError as e:
            seen["uneven"] = str(e)
        try:
            elastic.reshard({"x": w}, {"y": P("data")}, mesh)
            seen["mismatch"] = "no error"
        except ValueError as e:
            seen["mismatch"] = str(e)
        try:
            pmesh.to_placements(P(("model", "data")), mesh, 2)
            seen["order"] = "no error"
        except ValueError as e:
            seen["order"] = str(e)
        try:
            pmesh.make_production_mesh(device="cpu")
            seen["production"] = "no error"
        except ValueError as e:
            seen["production"] = str(e)
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(seen, fh)
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("elastic")
    procs = [spawn(__file__, "rank", r, WORLD, out / "store", out)
             for r in range(WORLD)]
    finish(procs, TIMEOUT_S)
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(WORLD)]


def test_full_fleet_mesh_and_reshard(ranks):
    w = np.arange(96.0).reshape(24, 4)
    for r, seen in enumerate(ranks):
        assert seen["plan"] == [4, 2]
        assert seen["shape"] == {"data": 4, "model": 2}
        assert seen["slot_none"] and seen["w_dtensor"]
        assert seen["w_placements"] and seen["w_full"]
        d, m = divmod(r, 2)
        np.testing.assert_array_equal(seen["w_local"],
                                      w[6 * d:6 * d + 6, 2 * m:2 * m + 2])
        assert seen["b_local"] == [1.0, 1.0]


def test_flat_groups_are_row_major(ranks):
    for r, seen in enumerate(ranks):
        assert seen["flat_rank"] == r
        d, m = divmod(r, 2)
        assert seen["dp_index"] == d
        assert seen["dp_sum"] == sum(2 * i + m for i in range(4))


def test_shrunk_mesh_reshards_the_same_state(ranks):
    w = np.arange(96.0).reshape(24, 4)
    for r, seen in enumerate(ranks):
        assert seen["small"] == [3, 2, 2]
        assert seen["mesh2_ranks"] == list(range(6))
        assert seen["in_mesh2"] == (r < 6)
        if r < 6:
            assert seen["w2_placements"] and seen["w2_full"]
            assert seen["slot2_none"]
            d, m = divmod(r, 2)
            np.testing.assert_array_equal(
                seen["w2_local"], w[8 * d:8 * d + 8, 2 * m:2 * m + 2])
        else:
            assert seen["w2_local_numel"] == 0


def test_refusals(ranks):
    for seen in ranks:
        assert "re-plan with plan_mesh(6, 2)" in seen["oversized"]
        assert "not divisible by 4" in seen["uneven"]
        assert "mismatched structure" in seen["mismatch"]
        assert "mesh's axis order" in seen["order"]
        assert "needs 256 ranks, the world has 8" in seen["production"]


# ---------------------------------------------------------------------------
# spec trees against JAX (pure functions)
# ---------------------------------------------------------------------------

def _specs_as_tuples(tree):
    return {k: _specs_as_tuples(v) if isinstance(v, dict) else tuple(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_side():
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.models import lm as jlm
    from repro.optim import adamw as jadamw
    return jax, jconfigs, jlm, jadamw


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_jax(arch, jax_side):
    jax, jconfigs, jlm, jadamw = jax_side
    from repro_torch import configs as pconfigs
    from repro_torch.models import convert, lm as plm
    from repro_torch.optim import adamw as padamw
    jc, pc = jconfigs.get_config(arch), pconfigs.get_config(arch)
    jspecs, pspecs = jlm.param_specs(jc), plm.param_specs(pc)
    assert convert.leaves_to_jax({k: tuple(v) for k, v in pspecs.items()}) \
        == _specs_as_tuples(jspecs)
    jshapes, pshapes = jlm.param_shapes(jc), plm.param_shapes(pc)
    assert convert.leaves_to_jax(pshapes) == jax.tree.map(
        lambda s: tuple(s.shape), jshapes)
    assert list(pspecs) == list(pshapes)
    for dp_axes, dp in ((("data",), 8), (("data",), 3),
                        (("pod", "data"), 8)):
        want = jadamw.opt_state_specs(jspecs, jshapes, dp_axes=dp_axes,
                                      dp_total=dp)
        got = padamw.opt_state_specs(pspecs, pshapes, dp_axes=dp_axes,
                                     dp_total=dp)
        assert tuple(got["step"]) == tuple(want["step"])
        for k in ("m", "v"):
            assert convert.leaves_to_jax(
                {n: tuple(s) for n, s in got[k].items()}) \
                == _specs_as_tuples(want[k]), (dp_axes, dp, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_jax(arch, jax_side):
    _, jconfigs, jlm, _ = jax_side
    from repro_torch import configs as pconfigs
    from repro_torch.models import lm as plm
    jc, pc = jconfigs.get_config(arch), pconfigs.get_config(arch)
    for data_axis, seq_axis in ((None, None), (("data",), ("model",)),
                                (None, ("data", "model")),
                                (("pod", "data"), "model")):
        want = jlm.cache_specs(jc, data_axis=data_axis, seq_axis=seq_axis)
        got = plm.cache_specs(pc, data_axis=data_axis, seq_axis=seq_axis)
        assert {k: tuple(v) for k, v in got.items()} \
            == _specs_as_tuples(want)
    assert set(plm.cache_shapes(pc, 2, 16)) == set(got)


def test_partition_spec_reads_as_jax():
    from jax.sharding import PartitionSpec as JP

    from repro_torch.launch.mesh import PartitionSpec as P
    for entries in ((), (None,), ("data", None), (("data",), "model"),
                    (("pod", "data"), None, "model")):
        assert tuple(P(*entries)) == tuple(JP(*entries))
    assert repr(P("data", None)) == "PartitionSpec('data', None)"


def test_zero1_spec_matches_jax():
    from jax.sharding import PartitionSpec as JP

    from repro.optim.adamw import zero1_spec as jz
    from repro_torch.launch.mesh import PartitionSpec as P
    from repro_torch.optim.adamw import zero1_spec as pz
    for spec, shape in ((P(None, "model"), (16, 2048)),
                        (P("model", None), (5, 6)), (P(), (7,)),
                        (P(None, None, "model", None), (16, 24, 8, 64))):
        for dp_axes, dp in ((("data",), 8), (("data",), 3),
                            (("pod", "data"), 4), (("data",), 0)):
            assert tuple(pz(spec, shape, dp_axes, dp)) == tuple(
                jz(JP(*spec), shape, dp_axes, dp))


if __name__ == "__main__":
    import torch
    torch.set_num_threads(1)
    rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
