"""The plain references against the port's CPU path at smoke size.

The same weights (``weights.py``, drawn from one seed) go to the port's
model and to the reference; the port's f32 prefill logits equal the
reference's to rounding, and its f32 training steps the reference's."""

import pytest
import torch

from perfbench import cells, harness, port, weights
from perfbench.reference import model as ref_model
from perfbench.sizes import sizes
from perfbench.tests import smoke

SEED = 2 ** 31 + 4242


@pytest.mark.parametrize("conf", [smoke.granite, smoke.mamba2],
                         ids=["granite_moe", "mamba2"])
def test_prefill_logits_match_the_port(conf):
    from repro_torch.launch.steps import (StepConfig, make_cache,
                                          make_prefill_step)
    s = sizes(conf())
    dev = torch.device("cpu")
    cfg, model = port.build_model(s, SEED, dev, torch.float32)
    scfg = StepConfig(param_dtype="float32", cache_dtype="float32")
    tokens = torch.randint(1, s.token_ids, (3, 40),
                           generator=torch.Generator().manual_seed(1))
    step = make_prefill_step(cfg, scfg, seq_len=40, batch=3, device=dev)
    cache = make_cache(cfg, scfg, batch=3, max_len=40, device=dev)
    got, _ = step(model, {"tokens": tokens}, cache)
    W = weights.all_leaves(s, SEED, dev, torch.float32)
    want = ref_model.last_logits(s, W, tokens)
    assert got.shape == want.shape == (3, s.vocab)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_moe_capacity_drops_tokens_in_order():
    from perfbench.reference import granite_moe
    s = sizes(smoke.granite())
    W = weights.all_leaves(s, SEED, torch.device("cpu"), torch.float32)
    x = torch.randn(1, 64, s.d_model, generator=torch.Generator()
                    .manual_seed(2))
    full = granite_moe.moe(s, W, 0, x, "f32")
    # the last token alone routes without contention: its output is the
    # same computed alone unless the capacity dropped one of its slots
    cap = granite_moe.capacity(s, 64)
    assert cap == max(s.min_capacity, -(-64 * s.top_k * 5 // (s.n_experts * 4)))
    alone = granite_moe.moe(s, W, 0, x[:, :1], "f32")
    torch.testing.assert_close(full[:, :1], alone, rtol=1e-5, atol=1e-6)


def test_training_steps_match_the_port():
    spec = smoke.spec("granite-moe.train", smoke.granite(), smoke.train_mix())
    run = harness.run_cell(spec, SEED, 0.0, False, torch.device("cpu"), 0.0)
    prog, ref = run.readings["program"], run.readings["reference"]
    assert len(prog["losses"]) == 3
    for a, b in zip(prog["losses"], ref["losses"]):
        assert abs(a - b) <= 1e-5 * abs(b)
    assert run.numbers["grad1_median_gap"] < 1e-4
    assert run.numbers["change_gap"] < 1e-4
    assert set(prog["grad1"]) == {lf.name for lf in weights.leaves(run.s)}


def test_leaf_gaps_are_against_the_leaf_or_the_median_leaf():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-9}
    prog = {"a": 1.1, "b": 2.0, "c": 2e-9}
    assert cells.leaf_gaps(prog, ref) == pytest.approx(
        {"a": 0.1, "b": 0.0, "c": 1e-9})
    # the median of the kept leaves (2.0 and 1e-9) is their mean
    assert cells.leaf_gaps(prog, ref, keep={"b", "c"}) == pytest.approx(
        {"b": 0.0, "c": 1e-9})


def test_train_numbers():
    ref = {"losses": [2.0, 1.0], "grad1": {"a": 1.0, "b": 2.0, "c": 4.0},
           "change": {"a": 1.0, "b": 1.0, "c": 1e-3}}
    prog = {"losses": [2.0, 1.01], "grad1": {"a": 1.0, "b": 2.2, "c": 4.0},
            "change": {"a": 1.0, "b": 1.0, "c": 0.5}}
    ref["grad1_s"] = {f"s{i}": torch.ones(4) for i in range(10)}
    prog["grad1_s"] = {f"s{i}": torch.ones(4) + 0.01 * (i + 1)
                       for i in range(10)}
    # a slice far smaller than the median one is measured against it
    ref["grad1_s"]["tiny"] = torch.full((4,), 1e-6)
    prog["grad1_s"]["tiny"] = torch.full((4,), 1e-6 + 0.05)
    got = cells.train_numbers(prog, ref)
    assert got["loss_gap"] == pytest.approx(0.01)
    assert got["grad1_median_gap"] == pytest.approx(0.0)
    assert got["change_gap"] == pytest.approx(0.499)
    # gaps 0.01 .. 0.10 and 0.05: the 2nd of 11 is the nearest-rank 10 %
    assert got["grad1_slice_q10"] == pytest.approx(0.02)
