"""The port's sweep command line beyond ``--check``: ``--update``,
``--cache``, ``--jobs``, ``--bench-engine`` and ``--profile``, with the
engine functions behind them, held to the JAX package's.

The cases mirror ``test_bench_baseline.py``'s on the port (on the CPU,
small grids): a partial ``--update`` merges and one without a baseline
is refused; the run cache round-trips, saves atomically and loads
nothing from a malformed, other-version, other-format or unreadable
file; the port refuses to write the JAX package's documents; the
throughput gate is relative and refuses documents of another device;
``--jobs 2`` through the spawned pool is bitwise ``--jobs 1``;
``make_baseline`` and the merge-order memo's counters equal the
reference's.
"""

import json
import os
import pathlib
import shutil

import pytest

from repro.core import simulator as rsim
from repro.experiments import SPECS as REF_SPECS
from repro.experiments import engine as rengine
from repro_torch import sweep
from repro_torch.core import fabric_cuda, fabric_torch
from repro_torch.core import simulator as psim
from repro_torch.experiments import (BASELINE_VERSION, SPECS,
                                     compare_to_baseline, load_disk_cache,
                                     make_baseline, record_key, run_spec,
                                     run_specs, save_disk_cache)
from repro_torch.experiments import engine as pengine

REPO = pathlib.Path(__file__).resolve().parent.parent
BASELINE_PATH = REPO / "BENCH_scenarios.json"
BENCH_REF_PATH = REPO / "BENCH_engine.json"
BENCH_PORT_PATH = REPO / "BENCH_engine_torch.json"
BASELINE = json.loads(BASELINE_PATH.read_text())
CPU = ["--engine", "cuda", "--device", "cpu"]


@pytest.fixture(autouse=True)
def fresh_cache():
    """No test sees (or leaves) another's run-cache records."""
    pengine._CACHE.clear()
    yield
    pengine._CACHE.clear()


# ---------------------------------------------------------------------------
# --update
# ---------------------------------------------------------------------------

def test_partial_update_keeps_other_specs(tmp_path, capsys):
    path = tmp_path / "baseline.json"
    shutil.copyfile(BASELINE_PATH, path)
    rc = sweep.main(["--specs", "fig7_aggregation", "--update", str(path),
                     *CPU])
    assert rc == 0, capsys.readouterr().err
    doc = json.loads(path.read_text())
    assert set(doc["specs"]) == set(SPECS)
    assert doc["generator"] == "python -m repro_torch.sweep --update"
    # the rewritten spec's records are the golden ones, bit for bit
    assert doc["specs"]["fig7_aggregation"] == \
        BASELINE["specs"]["fig7_aggregation"]
    for name in SPECS:
        assert doc["specs"][name] == BASELINE["specs"][name], name
    # and the document checks the fresh run
    assert sweep.main(["--specs", "fig7_aggregation,fig5_contention",
                       "--full", "--check", str(path), *CPU]) == 0
    assert "baseline check passed: 24 records" in capsys.readouterr().out


def test_full_update_reproduces_the_golden_document(tmp_path, capsys):
    """``--update`` of every spec (all 221 records, the XXL tier
    included) writes the golden document's specs exactly, and
    ``--check`` against the written file passes."""
    path = tmp_path / "baseline.json"
    assert sweep.main(["--update", str(path), *CPU]) == 0
    doc = json.loads(path.read_text())
    assert doc["version"] == BASELINE["version"]
    assert doc["specs"] == BASELINE["specs"]
    capsys.readouterr()
    assert sweep.main(["--smoke", "--specs", "halo1d,weak_scaling",
                       "--check", str(path), *CPU]) == 0
    assert "baseline check passed: 4 records" in capsys.readouterr().out


def test_partial_update_refuses_without_existing_baseline(tmp_path, capsys):
    missing = tmp_path / "missing.json"
    rc = sweep.main(["--specs", "fig7_aggregation", "--update",
                     str(missing), *CPU])
    assert rc == 2
    assert "full --update" in capsys.readouterr().err
    assert not missing.exists()


def test_partial_update_refuses_other_version(tmp_path, capsys):
    path = tmp_path / "old.json"
    path.write_text(json.dumps({"version": BASELINE_VERSION + 1,
                                "specs": {}}))
    before = path.read_text()
    assert sweep.main(["--specs", "fig7_aggregation", "--update", str(path),
                       *CPU]) == 2
    assert path.read_text() == before


def test_make_baseline_equals_reference():
    """Same layout, tolerances and records as the reference's document
    on the same results; only ``generator`` names the port."""
    specs = [SPECS[n] for n in ("fig7_aggregation", "halo1d",
                                "weak_scaling")]
    results = run_specs(specs, mode="smoke", engine="cuda", device="cpu")
    got = make_baseline(specs, results)
    want = rengine.make_baseline([REF_SPECS[s.name] for s in specs],
                                 results)
    assert got.pop("generator") == "python -m repro_torch.sweep --update"
    assert want.pop("generator").startswith("python -m benchmarks.sweep")
    assert got == want
    assert compare_to_baseline({**got, "generator": ""}, results) == []


# ---------------------------------------------------------------------------
# The run cache
# ---------------------------------------------------------------------------

def test_cache_round_trip_seeds_process_cache(tmp_path):
    path = tmp_path / "cache.json"
    spec = SPECS["fig7_aggregation"]
    run_spec(spec, mode="smoke", engine="cuda", device="cpu")
    run_spec(spec, mode="smoke", engine="vector", device="cpu")
    before = {k: dict(v) for k, v in pengine._CACHE.items()}
    assert save_disk_cache(str(path)) == len(before) == 8
    doc = json.loads(path.read_text())
    assert doc["format"] == pengine.CACHE_FORMAT
    assert doc["baseline_version"] == BASELINE_VERSION
    assert set(doc["records"]) == {"cpu"}
    assert set(doc["records"]["cpu"]) == {"cuda", "vector"}
    pengine._CACHE.clear()
    assert load_disk_cache(str(path)) == len(before)
    assert pengine._CACHE == before
    # a fully seeded cache means run_spec recomputes nothing: a poisoned
    # record flows through untouched
    key = record_key(spec.points("smoke")[0])
    pengine._CACHE[(spec.runner, key, "cuda", "cpu")]["time_us"] = -1.0
    assert run_spec(spec, mode="smoke", engine="cuda",
                    device="cpu")[key]["time_us"] == -1.0
    # the engine and the device key the records apart
    assert run_spec(spec, mode="smoke", engine="vector",
                    device="cpu")[key]["time_us"] > 0.0
    # loading again adds nothing that is already there
    assert load_disk_cache(str(path)) == 0


def test_cache_save_is_atomic_crash_mid_write(tmp_path, monkeypatch):
    """A crash before the temporary file replaces the cache leaves the
    old file byte for byte and no temporary file behind."""
    path = tmp_path / "cache.json"
    run_spec(SPECS["fig7_aggregation"], mode="smoke", engine="cuda",
             device="cpu")
    written = save_disk_cache(str(path))
    assert written == 4
    before = path.read_text()
    run_spec(SPECS["fig5_contention"], mode="smoke", engine="cuda",
             device="cpu")

    def crash(src, dst):
        assert pathlib.Path(src).read_text() != before  # new doc written
        raise RuntimeError("simulated crash mid-write")

    monkeypatch.setattr(pengine.os, "replace", crash)
    with pytest.raises(RuntimeError, match="mid-write"):
        save_disk_cache(str(path))
    monkeypatch.undo()
    assert path.read_text() == before
    assert list(tmp_path.glob("*.tmp")) == []
    pengine._CACHE.clear()
    assert load_disk_cache(str(path)) == written


def test_cache_malformed_file_is_ignored_wholesale(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({
        "format": pengine.CACHE_FORMAT,
        "baseline_version": BASELINE_VERSION,
        "records": {"cpu": {"cuda": {"oneshot": {
            "a": {"time_us": 1.0},
            "b": {"time_us": "not a number"}}}}}}))
    assert load_disk_cache(str(bad)) == 0
    assert pengine._CACHE == {}  # no partial seeding


@pytest.mark.parametrize("doc", [
    {"format": pengine.CACHE_FORMAT, "baseline_version": -1,
     "records": {"cpu": {"cuda": {"oneshot": {"k": {"time_us": 1.0}}}}}},
    # the JAX package's layout (engine -> runner -> key) is not the port's
    {"baseline_version": BASELINE_VERSION,
     "records": {"vector": {"oneshot": {"k": {"time_us": 1.0}}}}},
    ["not", "a", "document"],
], ids=["other-version", "reference-format", "not-a-dict"])
def test_cache_other_document_loads_nothing(tmp_path, doc):
    path = tmp_path / "cache.json"
    path.write_text(json.dumps(doc))
    assert load_disk_cache(str(path)) == 0
    assert pengine._CACHE == {}


def test_cache_unreadable_file_is_empty(tmp_path):
    assert load_disk_cache(str(tmp_path / "missing.json")) == 0
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert load_disk_cache(str(bad)) == 0
    assert load_disk_cache(str(tmp_path)) == 0  # a directory
    assert pengine._CACHE == {}


def test_cli_cache_flag(tmp_path, capsys):
    path = tmp_path / "cache.json"
    assert sweep.main(["--smoke", "--specs", "fig7_aggregation", "--cache",
                       str(path), *CPU]) == 0
    assert path.exists()
    capsys.readouterr()
    pengine._CACHE.clear()
    assert sweep.main(["--smoke", "--specs", "fig7_aggregation", "--cache",
                       str(path), "--check", str(BASELINE_PATH), *CPU]) == 0
    err = capsys.readouterr().err
    assert "loaded 4 cached records" in err


# ---------------------------------------------------------------------------
# The JAX package's documents are never rewritten
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag", ["--update", "--bench-out", "--cache"])
@pytest.mark.parametrize("name", ["BENCH_scenarios.json",
                                  "BENCH_engine.json"])
def test_refuses_to_write_reference_documents(flag, name, capsys,
                                              monkeypatch, tmp_path):
    target = REPO / name
    before = target.read_bytes()
    extra = ["--bench-engine"] if flag == "--bench-out" else []
    # the absolute path, and a relative one from another directory
    monkeypatch.chdir(tmp_path)
    for path in (str(target), os.path.relpath(target, tmp_path)):
        rc = sweep.main(["--specs", "fig4_latency", flag, path, *extra,
                         *CPU])
        assert rc == 2, path
        assert "never rewritten" in capsys.readouterr().err
    assert target.read_bytes() == before


def test_port_document_is_not_refused():
    assert not sweep.is_reference_document(str(BENCH_PORT_PATH))
    assert sweep.is_reference_document(str(REPO / "src" / ".." /
                                           "BENCH_engine.json"))


# ---------------------------------------------------------------------------
# --bench-engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag", [["--update", "x.json"], ["--check",
                                  str(BASELINE_PATH)], ["--out", "x.json"],
                                  ["--cache", "x.json"], ["--profile"]],
                         ids=lambda f: f[0])
def test_bench_engine_clash_exits_2(flag, capsys, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    assert sweep.main(["--bench-engine", "--specs", "fig4_latency", *flag,
                       *CPU]) == 2
    assert "cannot be combined with " + flag[0] in capsys.readouterr().err
    assert not (tmp_path / "x.json").exists()


def test_bench_engine_unknown_engine_exits_2(capsys):
    assert sweep.main(["--bench-engine", "--bench-engines", "vector,pallas",
                       "--specs", "fig4_latency", *CPU]) == 2
    assert "unknown --bench-engines ['pallas']" in capsys.readouterr().err


def test_bench_engine_document_on_cpu(tmp_path, capsys, monkeypatch):
    """A smoke document: one cell per (spec, allowed engine), the XXL
    tier on torch and cuda only, excluded runners left out, the device
    named; and each repeat starts from an empty run cache and cold
    memos."""
    entered = []
    real = sweep.run_spec

    def spy(spec, **kw):
        entered.append((spec.name, len(pengine._CACHE),
                        psim.merge_memo_stats()["size"]))
        return real(spec, **kw)
    monkeypatch.setattr(sweep, "run_spec", spy)
    monkeypatch.setattr(sweep, "BENCH_SPEC_ENGINES",
                        {"stencil3d": ("torch", "cuda")})
    out = tmp_path / "bench.json"
    rc = sweep.main(["--bench-engine", "--smoke", "--specs",
                     "fig5_contention,stencil3d,serving", "--bench-engines",
                     "vector,torch,cuda", "--bench-out", str(out), *CPU])
    assert rc == 0
    err = capsys.readouterr().err
    assert "bench excludes serving" in err
    doc = json.loads(out.read_text())
    assert doc["device"] == "cpu" and doc["mode"] == "smoke"
    cells = [(e["spec"], e["engine"]) for e in doc["entries"]]
    assert cells == [("fig5_contention", "vector"),
                     ("fig5_contention", "torch"), ("stencil3d", "torch"),
                     ("fig5_contention", "cuda"), ("stencil3d", "cuda")]
    for e in doc["entries"]:
        recs = BASELINE["specs"][e["spec"]]["records"]
        assert e["events"] == sum(recs[record_key(p)]["n_messages"] for p
                                  in SPECS[e["spec"]].points("smoke"))
        assert e["launches"] == 0  # the plain version on the CPU
        assert e["wall_s"] > 0 and e["events_per_sec"] > 0
    assert set(doc["totals"]) == {"vector", "torch", "cuda",
                                  "speedup_torch_vs_vector",
                                  "speedup_cuda_vs_torch"}
    assert len(entered) == 3 * len(cells)
    assert all(n_cache == 0 and n_memo == 0 for _, n_cache, n_memo in
               entered)
    assert pengine._CACHE == {}


def _doc(pair, num_eps, den_eps, events=50000, device="cpu"):
    num, den = pair
    return {"device": device, "entries": [
        {"spec": "s", "engine": num, "mode": "full", "events": events,
         "events_per_sec": num_eps},
        {"spec": "s", "engine": den, "mode": "full", "events": events,
         "events_per_sec": den_eps}]}


@pytest.mark.parametrize("pair", sweep.BENCH_PAIRS,
                         ids=lambda p: f"{p[0]}-vs-{p[1]}")
def test_regression_check_is_relative(pair):
    """The gate compares each pair's same-run ratio, so uniformly slower
    hardware never trips it."""
    check = sweep.check_bench_regression
    ref = _doc(pair, 1e6, 1e5)                         # committed: 10x
    assert check(_doc(pair, 6e5, 1e5), ref) == []      # 6x
    assert check(_doc(pair, 5e5, 5e4), ref) == []      # slower, same 10x
    slow = _doc(pair, 4e5, 1e5)                        # 4x: >2x drop
    assert len(check(slow, ref)) == 1
    assert check(slow, _doc(pair, 1e6, 1e5, events=10)) == []  # noise
    # a pair the fresh document did not measure is not gated
    assert check({"device": "cpu", "entries": []}, ref) == []


def test_regression_check_refuses_other_device():
    pair = sweep.BENCH_PAIRS[2]
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    with pytest.raises(ValueError, match="H100"):
        sweep.check_bench_regression(_doc(pair, 1e6, 1e5),
                                     _doc(pair, 1e6, 1e5, device=card))
    assert sweep.check_bench_regression(
        _doc(pair, 1e6, 1e5, device=card),
        _doc(pair, 1e6, 1e5, device=card)) == []


def test_bench_check_of_another_device_exits_2(tmp_path, capsys):
    ref = tmp_path / "ref.json"
    ref.write_text(json.dumps(_doc(("cuda", "torch"), 1e6, 1e5,
                                   device="NVIDIA H100 80GB HBM3, 700.00 W")))
    assert sweep.main(["--bench-engine", "--smoke", "--specs",
                       "fig4_latency", "--bench-engines", "vector",
                       "--bench-check", str(ref), *CPU]) == 2
    assert "cannot compare" in capsys.readouterr().err


def test_bench_check_unreadable_exits_2(tmp_path):
    assert sweep.main(["--bench-engine", "--specs", "fig4_latency",
                       "--bench-check", str(tmp_path / "missing.json"),
                       *CPU]) == 2


def test_committed_port_document():
    """``BENCH_engine_torch.json`` was measured on the card: it names
    the card and its power limit, covers every bench cell of the full
    grids on the four engines (the XXL tier on torch and cuda only),
    and shows the kernel launched on the XXL tier."""
    doc = json.loads(BENCH_PORT_PATH.read_text())
    assert doc["version"] == sweep.BENCH_VERSION and doc["mode"] == "full"
    assert "H100" in doc["device"] and doc["device"].endswith(" W")
    for mode in ("smoke", "full"):
        cells = {(e["spec"], e["engine"]): e for e in doc["entries"]
                 if e["mode"] == mode}
        for name, spec in SPECS.items():
            allowed = sweep.BENCH_SPEC_ENGINES.get(name, sweep.BENCH_ENGINES)
            for engine in sweep.BENCH_ENGINES:
                want = spec.runner not in sweep.BENCH_EXCLUDED_RUNNERS \
                    and engine in allowed
                assert ((name, engine) in cells) == want, (mode, name,
                                                           engine)
        assert cells[("weak_scaling_xxl", "cuda")]["launches"] >= 1
    for num, den in sweep.BENCH_PAIRS:
        assert doc["totals"][f"speedup_{num}_vs_{den}"] > 0


def test_bench_engine_needs_the_card_unless_cpu_is_asked():
    """The default device is the card; without one the command raises
    instead of measuring the host."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.main(["--bench-engine", "--specs", "fig4_latency"])


# ---------------------------------------------------------------------------
# --jobs
# ---------------------------------------------------------------------------

def test_jobs_2_is_bitwise_jobs_1(monkeypatch):
    """Per-point records from two spawned workers equal the in-process
    run's float for float; stencil grids stay on the whole-grid path in
    the parent."""
    specs = [SPECS[n] for n in ("fig5_contention", "halo1d",
                                "weak_scaling")]
    pooled = []
    real = pengine.WorkerPool.map

    def spy(self, args):
        pooled.append((id(self), args[0][0], len(args), self.jobs))
        return real(self, args)
    monkeypatch.setattr(pengine.WorkerPool, "map", spy)
    two = run_specs(specs, mode="full", engine="cuda", device="cpu", jobs=2)
    # one pool of two workers serves both specs
    assert [p[1:] for p in pooled] == [("oneshot", 18, 2), ("halo", 12, 2)]
    assert pooled[0][0] == pooled[1][0]
    pengine._CACHE.clear()
    one = run_specs(specs, mode="full", engine="cuda", device="cpu")
    assert len(pooled) == 2
    assert json.dumps(two, sort_keys=True) == json.dumps(one, sort_keys=True)
    assert two == one
    assert compare_to_baseline(BASELINE, two) == []


def test_cli_jobs_checks_baseline(capsys):
    assert sweep.main(["--full", "--specs", "fig8_earlybird", "--jobs", "2",
                       "--check", str(BASELINE_PATH), *CPU]) == 0
    assert "baseline check passed: 16 records" in capsys.readouterr().out
    assert sweep.main(["--specs", "fig8_earlybird", "--jobs", "0",
                       *CPU]) == 2


def test_run_records_without_a_pool_starts_its_own():
    spec = SPECS["fig8_earlybird"]
    got = pengine.run_records(spec.runner, spec.points("full"),
                              engine="cuda", device="cpu", jobs=2)
    pengine._CACHE.clear()
    assert got == pengine.run_records(spec.runner, spec.points("full"),
                                      engine="cuda", device="cpu")


# ---------------------------------------------------------------------------
# Memo counters and --profile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["weak_scaling", "stencil3d", "halo1d"])
def test_merge_memo_stats_equal_reference(name):
    """After a cold start and the same runs on engine vector (the second
    with the run cache cleared, so the merge memo hits), the port's
    merge-order counters equal the reference's."""
    stats = []
    for sim, eng, kw in ((psim, pengine, {"device": "cpu"}),
                         (rsim, rengine, {})):
        spec = (SPECS if eng is pengine else REF_SPECS)[name]
        eng._CACHE.clear()
        sim.clear_merge_memo()
        assert sim.merge_memo_stats()["messages_saved"] == 0
        eng.run_spec(spec, mode="smoke", engine="vector", **kw)
        eng._CACHE.clear()
        eng.run_spec(spec, mode="smoke", engine="vector", **kw)
        stats.append(sim.merge_memo_stats())
        eng._CACHE.clear()
        sim.clear_merge_memo()
    assert stats[0] == stats[1]
    if name != "halo1d":  # the ring merges nothing memoized
        assert stats[0]["hits"] > 0 and stats[0]["messages_saved"] > 0


def test_clear_merge_memo_resets_every_counter():
    spec = SPECS["weak_scaling"]
    for _ in range(2):
        pengine._CACHE.clear()
        run_spec(spec, mode="smoke", engine="cuda", device="cpu")
    memos = sweep.memo_stats("cuda")
    assert set(memos) == {"merge", "grid", "layout", "cuda grid_ops",
                          "cuda arrivals"}
    assert memos["grid"]["hits"] == 2 and memos["grid"]["misses"] == 2
    assert memos["layout"] == fabric_torch.layout_memo_stats()
    assert memos["cuda grid_ops"] == fabric_cuda.memo_stats()["grid_ops"]
    assert memos["cuda grid_ops"]["size"] >= 1
    psim.clear_merge_memo()
    for st in sweep.memo_stats("cuda").values():
        assert st["hits"] == st["misses"] == st["evictions"] == 0
        assert st["size"] == 0
    assert psim.merge_memo_stats()["messages_saved"] == 0
    assert set(sweep.memo_stats("vector")) == {"merge"}
    assert set(sweep.memo_stats("torch")) == {"merge", "grid", "layout"}


def test_cli_profile(capsys):
    assert sweep.main(["--profile", "--profile-top", "3", "--smoke",
                       "--specs", "weak_scaling,fig6_vci", *CPU]) == 0
    cap = capsys.readouterr()
    assert "cProfile, top 3 by cumulative time" in cap.err
    assert "merge-layout memo: pass 1 (cold)" in cap.err
    # the second pass reuses both grid points
    assert "grid-point memo: 2 hits, 2 misses" in cap.err
    assert "cuda grid_ops memo:" in cap.err
    assert "cuda arrivals memo:" in cap.err
    assert "# weak_scaling: 2 records (smoke, cuda on cpu)" in cap.out
    assert "crossover part vs pt2pt_single" in cap.out


def test_profile_specs_returns_both_walls():
    results, prof = sweep.profile_specs([SPECS["weak_scaling"]], "smoke",
                                        "torch", "cpu")
    assert compare_to_baseline(BASELINE, results) == []
    assert prof["cold_s"] > 0 and prof["warm_s"] > 0
    assert prof["launches"] == 0
    assert prof["memos"]["grid"]["hits"] == 2
