"""The port's stencil sweeps against the committed golden baseline.

The ``weak_scaling`` smoke tier (a 512-rank torus) and the ``stencil3d``
smoke tier run through the port's whole-grid path on the ``torch`` and
``cuda`` engines (on the CPU) and must reproduce ``BENCH_scenarios.json``
with no violation; the port's specs expand to the same records as the
JAX package's.
"""

import json
import pathlib

import pytest

from repro.experiments import SPECS as REF_SPECS
from repro.experiments import engine as rengine
from repro_torch import sweep
from repro_torch.experiments import SPECS, compare_to_baseline, run_spec
from repro_torch.experiments import engine as pengine

BASELINE_PATH = pathlib.Path(__file__).resolve().parent.parent / \
    "BENCH_scenarios.json"
BASELINE = json.loads(BASELINE_PATH.read_text())


@pytest.mark.parametrize("spec", ["weak_scaling", "stencil3d"])
@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_smoke_tier_reproduces_baseline(engine, spec):
    pengine._CACHE.clear()
    results = run_spec(SPECS[spec], mode="smoke", engine=engine,
                       device="cpu")
    assert len(results) == 2
    violations = compare_to_baseline(BASELINE, {spec: results})
    assert not violations, "\n".join(violations)
    for key, metrics in results.items():
        ref = BASELINE["specs"][spec]["records"][key]
        assert metrics["n_messages"] == ref["n_messages"]


@pytest.mark.parametrize("name", sorted(SPECS))
def test_specs_expand_like_the_reference(name):
    for mode in ("smoke", "full"):
        got = [pengine.record_key(p) for p in SPECS[name].points(mode)]
        want = [rengine.record_key(p) for p in REF_SPECS[name].points(mode)]
        assert got == want
    assert SPECS[name].baseline_approach == REF_SPECS[name].baseline_approach


def test_engines_share_records_bitwise():
    """torch and cuda records of one tier are equal float for float."""
    pengine._CACHE.clear()
    spec = SPECS["weak_scaling"]
    a = run_spec(spec, "smoke", engine="torch", device="cpu")
    b = run_spec(spec, "smoke", engine="cuda", device="cpu")
    assert a == b


def test_compare_to_baseline_flags_drift():
    key, rec = next(iter(
        BASELINE["specs"]["weak_scaling"]["records"].items()))
    assert compare_to_baseline(BASELINE, {"weak_scaling": {key: rec}}) == []
    drift = {key: {**rec, "time_us": rec["time_us"] * 1.05}}
    assert len(compare_to_baseline(BASELINE, {"weak_scaling": drift})) == 1
    exact = {key: {**rec, "n_messages": rec["n_messages"] + 1}}
    assert len(compare_to_baseline(BASELINE, {"weak_scaling": exact})) == 1
    assert compare_to_baseline({"version": 0}, {}) != []


def test_cli_checks_baseline(capsys):
    rc = sweep.main(["--spec", "weak_scaling", "--smoke", "--engine", "cuda",
                     "--device", "cpu", "--check", str(BASELINE_PATH)])
    assert rc == 0
    assert "baseline check passed: 2 records" in capsys.readouterr().out
    assert sweep.main(["--spec", "no_such_spec", "--device", "cpu"]) == 2


def test_specs_cover_197_golden_records():
    """All 19 of the reference's specs, in its order, whose full grids
    come to all 221 records of the golden baseline (the 197 of the
    scenario and stencil specs, and the planner's autotune and
    ir_passes) — from expansion alone, no stencil tier is run."""
    assert len(SPECS) == 19
    assert list(SPECS) == list(REF_SPECS)
    keys = {(name, pengine.record_key(p))
            for name, spec in SPECS.items() for p in spec.points("full")}
    assert len(keys) == 221
    assert sum(len(s["records"]) for s in BASELINE["specs"].values()) == 221
    for name, key in keys:
        assert key in BASELINE["specs"][name]["records"], (name, key)
    for name, spec in SPECS.items():
        assert spec.runner in pengine.RUNNERS
        assert spec.runner in pengine.PRIMARY_METRIC
        assert spec.tolerances == REF_SPECS[name].tolerances
        assert spec.tol_rel == REF_SPECS[name].tol_rel


def test_parse_key_inverts_record_key():
    for spec in SPECS.values():
        for p in spec.points("smoke"):
            key = pengine.record_key(p)
            assert pengine.parse_key(key) == rengine.parse_key(key)
            assert pengine.record_key(pengine.parse_key(key)) == key


def test_cli_lists_specs(capsys):
    assert sweep.main(["--list"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 19
    assert out[0].split()[:3] == ["fig4_latency", "oneshot", "20"]
    assert any(line.split()[:3] == ["serving_faults", "servingfaults", "4"]
               for line in out)
    assert any(line.split()[:3] == ["autotune", "autotune", "18"]
               for line in out)
    assert any(line.split()[:3] == ["ir_passes", "ir", "6"] for line in out)


def test_cli_writes_results_and_prints_crossover(capsys, tmp_path):
    out = tmp_path / "results.json"
    rc = sweep.main(["--spec", "fig6_vci,halo1d", "--smoke", "--engine",
                     "cuda", "--device", "cpu", "--out", str(out),
                     "--check", str(BASELINE_PATH)])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "# crossover part vs pt2pt_single: slowdown_at_1_vcis=" \
        in printed
    assert "# crossover pt2pt_many vs pt2pt_single:" in printed
    assert "baseline check passed: 8 records" in printed
    doc = json.loads(out.read_text())
    assert (doc["mode"], doc["engine"], doc["device"]) == \
        ("smoke", "cuda", "cpu")
    assert sorted(doc["results"]) == ["fig6_vci", "halo1d"]
    assert len(doc["results"]["fig6_vci"]) == 6
