"""Import hygiene of the PyTorch port and its plan layer.

Importing every ``repro_torch`` module in a fresh interpreter must load
no ``jax`` module and nothing of the JAX package ``repro`` or of its
``benchmarks``; the port keeps its own copies of the plan layer,
topology and NumPy fabric, which must agree with the reference's.
"""

import ast
import pathlib
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

import repro_torch
from repro.core import commplan as rcp
from repro.core import partition as rpart
from repro.core import topology as rtopo
from repro_torch.core import commplan as pcp
from repro_torch.core import partition as ppart
from repro_torch.core import topology as ptopo

REPO = pathlib.Path(__file__).resolve().parent.parent
MODULES = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, prefix="repro_torch."))


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, sys\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith(('jax.', 'jaxlib')) or m == 'repro'"
        " or m.startswith('repro.') or m == 'benchmarks'"
        " or m.startswith('benchmarks.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(MODULES) >= 12


def test_planner_and_ir_sources_are_covered():
    """The planner slice's sources are among the modules imported above
    and the files scanned below."""
    for name in ("repro_torch.core.planner", "repro_torch.core.plan_ir",
                 "repro_torch.autotune"):
        assert name in MODULES, name
        path = REPO / "src" / (name.replace(".", "/") + ".py")
        assert path.is_file() and not [
            m for m in _imported_names(path)
            if m.split(".")[0] in ("jax", "jaxlib", "repro")]


def test_evaluation_tooling_sources_are_covered():
    """The sweep and chaos command lines and every module of the port's
    benchmark harness are among the modules imported above and the
    files scanned below; none names the JAX package's ``benchmarks``."""
    harness = ("common", "tableA_delayrate", "fig4_latency",
               "fig5_congestion", "fig6_vci", "fig7_aggregation",
               "fig8_earlybird", "scen_steady", "scen_halo", "scen_stencil",
               "scen_imbalance", "scen_serving", "scen_faults", "earlybird",
               "run")
    for name in ("repro_torch.sweep", "repro_torch.chaos",
                 *(f"repro_torch.benchmarks.{m}" for m in harness)):
        assert name in MODULES, name
        path = REPO / "src" / (name.replace(".", "/") + ".py")
        assert path.is_file() and not [
            m for m in _imported_names(path)
            if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks")]


def _imported_names(path):
    """Every module an ``import`` statement anywhere in ``path`` names,
    function-local imports included."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [*(REPO / "src" / "repro_torch").rglob("*.py"), REPO / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_names_jax_or_repro(path):
    bad = [m for m in _imported_names(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks")]
    assert not bad, f"{path.name} imports {bad}"


def _plan_fields(plan):
    return [(m.index, m.items, m.nbytes, m.channel) for m in plan.messages]


@pytest.mark.parametrize("n_send,n_recv,item_bytes,aggr,ch", [
    (8, 8, 4096.0, 0.0, 1), (12, 8, 1000.0, 8192.0, 3),
    (64, 16, 64.0, 2048.0, 4), (5, 10, 3.5, 0.0, 2)])
def test_plan_uniform_matches_reference(n_send, n_recv, item_bytes, aggr,
                                        ch):
    got = pcp.plan_uniform(n_send, n_recv, item_bytes, aggr_bytes=aggr,
                           n_channels=ch)
    want = rcp.plan_uniform(n_send, n_recv, item_bytes, aggr_bytes=aggr,
                            n_channels=ch)
    assert _plan_fields(got) == _plan_fields(want)
    req_got = ppart.PartitionedRequest(n_send, n_recv, item_bytes,
                                       aggr_bytes=aggr, n_channels=ch)
    req_want = rpart.PartitionedRequest(n_send, n_recv, item_bytes,
                                        aggr_bytes=aggr, n_channels=ch)
    assert _plan_fields(req_got.plan) == _plan_fields(req_want.plan)
    assert req_got.ready_times_to_send_times(list(range(n_send))) == \
        req_want.ready_times_to_send_times(list(range(n_send)))


@pytest.mark.parametrize("aggr", [0.0, 100.0, 4096.0])
def test_plan_sized_matches_reference(aggr):
    sizes = np.random.default_rng(0).uniform(1.0, 1500.0, size=40).tolist()
    assert _plan_fields(pcp.plan_sized(sizes, aggr_bytes=aggr,
                                       n_channels=3)) == \
        _plan_fields(rcp.plan_sized(sizes, aggr_bytes=aggr, n_channels=3))


@pytest.mark.parametrize("dims,periodic", [
    ((4,), True), ((3, 2), (True, False)), ((2, 2, 2), True),
    ((4, 1, 3), False)])
def test_topology_matches_reference(dims, periodic):
    got = ptopo.CartTopology.create(dims, periodic)
    want = rtopo.CartTopology.create(dims, periodic)
    for a, b in zip(got.flow_arrays(), want.flow_arrays()):
        assert np.array_equal(a, b)
    assert [(f.src, f.dst, f.dim, f.direction) for f in got.flows()] == \
        [(f.src, f.dst, f.dim, f.direction) for f in want.flows()]
    shape = (24, 8, 4)[:len(dims)]
    assert ptopo.HaloSpec.create(got, shape).all_face_bytes() == \
        rtopo.HaloSpec.create(want, shape).all_face_bytes()
