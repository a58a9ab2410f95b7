"""The port's benchmark harness against the JAX package's.

Each of the twelve driver modules (Table A, Figs 4-8 and the six
scenario drivers) gives the reference module's rows, name for name,
value for value and ``derived`` string for string, and the scenario
modules the same result dicts, on engines ``vector`` and ``cuda`` (its
plain version on the CPU): the engines are bit-for-bit in float64.
``run --fast --json`` prints the reference's CSV and writes its JSON.
The early-bird rows run 8 gloo ranks: all-reduces a step equal to the
reference plan's buckets plus one for the loss in each mode, and the
bytes a rank to the plan's bucket bytes plus the loss's.
"""

import contextlib
import importlib
import io
import json
import sys

import numpy as np
import pytest

from repro_torch.benchmarks import earlybird, run

MODULES = ("tableA_delayrate", "fig4_latency", "fig5_congestion",
           "fig6_vci", "fig7_aggregation", "fig8_earlybird", "scen_steady",
           "scen_halo", "scen_stencil", "scen_imbalance", "scen_serving",
           "scen_faults")


def _pair(name):
    return (importlib.import_module(f"benchmarks.{name}"),
            importlib.import_module(f"repro_torch.benchmarks.{name}"))


@pytest.mark.parametrize("engine", ["vector", "cuda"])
@pytest.mark.parametrize("name", MODULES)
def test_module_rows_equal_reference(name, engine):
    ref, port = _pair(name)
    want = ref.rows()
    got = port.rows(engine=engine, device="cpu")
    assert [r[0] for r in got] == [r[0] for r in want]
    assert got == want
    if hasattr(ref, "results"):
        assert port.results(engine=engine, device="cpu") == ref.results()


@pytest.mark.parametrize("seed", [0, 7])
def test_imbalance_seed_threads_through(seed):
    ref, port = _pair("scen_imbalance")
    assert port.rows(seed, engine="cuda", device="cpu") == ref.rows(seed)
    assert port.results(seed, engine="cuda", device="cpu") == \
        ref.results(seed)


def test_modules_mirror_reference_constants():
    for name in MODULES:
        ref, port = _pair(name)
        for attr in ("APPROACHES", "SIZES", "AGGRS", "GAMMA", "ITERS", "KW",
                     "RANKS", "GRIDS", "LOCAL", "WORKLOADS", "ARRIVALS",
                     "RATES_RPS", "FIXED", "FAULT_RATES", "MEMBER"):
            if hasattr(ref, attr):
                assert getattr(port, attr) == getattr(ref, attr), (name,
                                                                   attr)


def _reference_run(argv, monkeypatch):
    """``python -m benchmarks.run`` in process: it reads ``sys.argv``."""
    from benchmarks import run as ref_run
    monkeypatch.setattr(sys, "argv", ["benchmarks.run", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ref_run.main()
    return out.getvalue()


@pytest.mark.parametrize("engine", ["cuda", "torch"])
def test_run_fast_json_equals_reference(engine, tmp_path, monkeypatch,
                                        capsys):
    want_csv = _reference_run(["--fast", "--json", str(tmp_path / "r.json"),
                               "--seed", "3"], monkeypatch)
    capsys.readouterr()
    rc = run.main(["--fast", "--json", str(tmp_path / "p.json"), "--seed",
                   "3", "--engine", engine, "--device", "cpu"])
    assert rc == 0
    got_csv = capsys.readouterr().out
    assert got_csv == want_csv
    lines = got_csv.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert len(lines) == 1 + 288
    assert json.loads((tmp_path / "p.json").read_text()) == \
        json.loads((tmp_path / "r.json").read_text())
    assert run.collect(3, engine, "cpu") == [
        row for name in MODULES for row in
        (_pair(name)[0].rows(3) if name == "scen_imbalance"
         else _pair(name)[0].rows())]


def test_run_default_json_path_and_bad_seed(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert run.main(["--fast", "--json", "--device", "cpu"]) == 0
    assert (tmp_path / "benchmark_results.json").exists()
    with pytest.raises(SystemExit) as e:
        run.main(["--fast", "--seed", "-1", "--device", "cpu"])
    assert e.value.code == 2


def test_run_needs_the_card_unless_cpu_is_asked(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--fast"]) == 2
    assert "device='cpu'" in capsys.readouterr().err


def test_run_without_fast_prints_earlybird_and_names_the_gap(monkeypatch,
                                                              capsys):
    rows = [("earlybird/bulk/wall", 1.0, "ranks=8")]
    monkeypatch.setattr(earlybird, "rows", lambda: rows)
    assert run.main(["--device", "cpu", "--engine", "vector"]) == 0
    cap = capsys.readouterr()
    assert cap.out.splitlines()[-1] == "earlybird/bulk/wall,1.000,ranks=8"
    assert "roofline_report rows not printed" in cap.err
    assert "ROADMAP item 9" in cap.err


def test_module_main_prints_rows_and_json(capsys):
    from repro_torch.benchmarks import common, scen_halo
    common.module_main(scen_halo, ["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 12 and out[0].startswith("halo/pt2pt_single/2ranks")
    common.module_main(scen_halo, ["--device", "cpu", "--json"])
    assert json.loads(capsys.readouterr().out) == \
        _pair("scen_halo")[0].results()


# ---------------------------------------------------------------------------
# The early-bird rows on 8 gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks():
    return earlybird.run_ranks(timeout=300)


def _reference_plan(mode: str):
    """(buckets, bytes) of the JAX package's plan for one step of
    ``mode`` on the benchmark's model: the whole tree at 256 MiB (bulk)
    or 0 (per_leaf); each layer's leaves at the bucket bound plus the
    rest at it (partitioned)."""
    import dataclasses

    import jax
    from repro.configs import get_smoke_config
    from repro.core import bucketing as jb
    from repro.models import lm as jlm
    jcfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), n_layers=8,
                               d_model=128, d_ff=512, vocab=2048)
    shapes = jlm.param_shapes(jcfg)
    leaves = jax.tree.leaves(shapes)
    nbytes = sum(int(np.prod(s.shape)) * np.dtype(s.dtype).itemsize
                 for s in leaves)
    if mode != "partitioned":
        aggr = 256 << 20 if mode == "bulk" else 0
        return jb.make_plan(leaves, aggr).n_buckets, nbytes
    layer = [jax.ShapeDtypeStruct(s.shape[1:], s.dtype)
             for s in jax.tree.leaves(shapes["layers"])]
    rest = [v for k, v in shapes.items() if k != "layers"]
    aggr = earlybird.AGGR_BYTES
    return (jcfg.n_layers * jb.make_plan(layer, aggr).n_buckets
            + jb.make_plan(jax.tree.leaves(rest), aggr).n_buckets), nbytes


@pytest.mark.parametrize("mode", earlybird.MODES)
def test_earlybird_counts_equal_reference_plan(ranks, mode):
    buckets, nbytes = _reference_plan(mode)
    assert len(ranks) == earlybird.WORLD == 8
    for r in ranks:
        assert r[mode]["all_reduces"] == buckets + 1
        assert r[mode]["logged"] == buckets + 1
        assert r[mode]["bytes"] == nbytes + 4  # + the f32 loss
        assert r[mode]["wall_s"] > 0


def test_earlybird_modes_order_and_loss(ranks):
    n = {m: ranks[0][m]["all_reduces"] for m in earlybird.MODES}
    assert n["bulk"] < n["per_leaf"] < n["partitioned"], n
    # the synced loss is the global mean: one value on every rank
    for m in earlybird.MODES:
        assert len({r[m]["loss"] for r in ranks}) == 1
    np.testing.assert_allclose(
        [ranks[0][m]["loss"] for m in earlybird.MODES],
        ranks[0]["bulk"]["loss"], rtol=1e-6)


def test_earlybird_rows(ranks, monkeypatch):
    monkeypatch.setattr(earlybird, "run_ranks", lambda: ranks)
    rows = earlybird.rows()
    assert [r[0] for r in rows] == [f"earlybird/{m}/wall"
                                    for m in earlybird.MODES]
    for (_, us, derived), m in zip(rows, earlybird.MODES):
        assert us == max(r[m]["wall_s"] for r in ranks) * 1e6
        assert derived == (f"ranks=8,all_reduces={ranks[0][m]['all_reduces']}"
                           f",ar_bytes={ranks[0][m]['bytes']}")
        assert "pred_ici_us" not in derived
