"""``python -m repro_torch.chaos`` against ``python -m benchmarks.chaos``.

The port's command exits 0 with no violation and writes a report whose
campaigns (kinds, policies, scenarios, retransmission counts) equal the
JAX package's report for the same seed and count; a forced violation
exits 1, and the card is asked for unless ``--device cpu`` is given.
"""

import json

import pytest

from benchmarks import chaos as ref_cli
from repro_torch import chaos as port_cli
from repro_torch.experiments import chaos as pchaos


@pytest.mark.parametrize("engine", ["cuda", "torch", "vector"])
def test_report_equals_reference(engine, tmp_path, capsys):
    ref_out, port_out = tmp_path / "ref.json", tmp_path / "port.json"
    assert ref_cli.main(["--campaigns", "8", "--seed", "2", "--out",
                         str(ref_out)]) == 0
    capsys.readouterr()
    assert port_cli.main(["--campaigns", "8", "--seed", "2", "--out",
                          str(port_out), "--engine", engine, "--device",
                          "cpu", "--verbose"]) == 0
    out = capsys.readouterr().out
    assert "8 campaigns (seed 2, 2 serving" in out
    assert "0 violations" in out
    assert out.count("[ok]") == 8
    ref, port = (json.loads(p.read_text()) for p in (ref_out, port_out))
    assert port["n_violations"] == 0 and port["violations"] == []
    assert port["engine"] == engine and port["device"] == "cpu"
    assert [(c["kind"], c["policy"], c["n_retransmits"])
            for c in port["campaigns"]] == \
        [(c["kind"], c["policy"], c["n_retransmits"])
         for c in ref["campaigns"]]
    assert port["campaigns"] == ref["campaigns"]
    for key in ("n_campaigns", "seed", "by_policy", "n_serving"):
        assert port[key] == ref[key], key


def test_forced_violation_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(pchaos, "_faulty_equal", lambda a, b: False)
    assert port_cli.main(["--campaigns", "2", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    # engine agreement in both campaigns, and campaign 0's re-run
    assert "3 violations" in out
    for line in ("campaign 0: cuda != reference on faulty stencil",
                 "campaign 0: determinism: identical campaign re-run"
                 " diverged",
                 "campaign 1: cuda != reference on faulty stencil"):
        assert f"VIOLATION: {line}" in out


def test_default_device_is_the_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert port_cli.main(["--campaigns", "1"]) == 2
    assert "device='cpu'" in capsys.readouterr().err


def test_bad_engine_is_refused():
    with pytest.raises(SystemExit) as e:
        port_cli.main(["--engine", "pallas", "--device", "cpu"])
    assert e.value.code == 2
