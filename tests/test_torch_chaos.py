"""The port's chaos harness: seeded fault campaigns on the ``cuda`` and
``torch`` engines (on the CPU) against the ``reference`` engine.

Every campaign must hold the harness's invariants (engine agreement,
message, hedge and request conservation, monotone clocks, bounded
rounds, exact replay) with no violation, and draw the same scenario,
policy and counters as the JAX package's campaign of the same index.
"""

import pytest

from repro.experiments import chaos as rchaos
from repro_torch.experiments import chaos as pchaos

N_CAMPAIGNS = 8


@pytest.fixture(scope="module")
def reference_report():
    return rchaos.run_campaigns(N_CAMPAIGNS, seed=1)


@pytest.mark.parametrize("engine", ["cuda", "torch"])
def test_small_campaign_has_no_violations(engine, reference_report):
    seen = []
    report = pchaos.run_campaigns(N_CAMPAIGNS, seed=1, engine=engine,
                                  device="cpu",
                                  progress=lambda i, info: seen.append(i))
    assert report["n_violations"] == 0, report["violations"]
    assert seen == list(range(N_CAMPAIGNS))
    assert report["engine"] == engine
    assert report["n_serving"] == N_CAMPAIGNS // 4
    assert report["campaigns"] == reference_report["campaigns"]
    assert report["by_policy"] == reference_report["by_policy"]


@pytest.mark.parametrize("idx", [3, 8])
def test_campaign_replays_from_its_index(idx):
    """A serving campaign (3) and a stencil campaign with the
    determinism re-run (8): each equals the reference's summary."""
    got = pchaos.run_campaign(idx, seed=5, engine="cuda", device="cpu")
    assert got == rchaos.run_campaign(idx, seed=5)
    assert got["violations"] == []
    assert got["kind"] == ("serving" if idx % 4 == 3 else "stencil")


def test_campaigns_reject_bad_arguments():
    with pytest.raises(ValueError, match="at least 1"):
        pchaos.run_campaigns(0, device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        pchaos.run_campaign(0, engine="pallas", device="cpu")
