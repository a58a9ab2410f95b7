"""A whole run with the timed path broken underneath comes out not
correct, once for each fault a cell can have; the sound run comes out
correct.  The runs skip the look for a chip and run the port's CPU path
at smoke size, each cell against the numbers its own limits file
(``limits/``) compares, at smoke-size limits (``smoke.SMOKE_LIMITS``)."""

import pytest
import torch

from perfbench import cells, harness
from perfbench.tests import smoke

SEED = 2 ** 31 + 777
CPU = torch.device("cpu")


def _train(make_step=cells._default_train_step):
    spec = smoke.spec("granite-moe.train", smoke.granite(), smoke.train_mix())
    run = harness.run_cell(spec, SEED, 0.5, False, CPU, 0.0,
                           make_step=make_step)
    return harness.result(spec, run, False, {"platform": "cpu"})


def _unchanged(cfg, scfg, *, seq_len, batch, device):
    """A step that returns its state unchanged."""
    inner = cells._default_train_step(cfg, scfg, seq_len=seq_len,
                                      batch=batch, device=device)

    def step(state, b):
        keep = {k: p.detach().clone()
                for k, p in state["params"].named_parameters()}
        state, loss = inner(state, b)
        with torch.no_grad():
            for k, p in state["params"].named_parameters():
                p.copy_(keep[k])
        return state, loss
    step.log = inner.log
    return step


def _half_batch(cfg, scfg, *, seq_len, batch, device):
    """Half of the batch left out, the mean taken over the rest."""
    from perfbench.calibrate import _half_batch_step
    return _half_batch_step(cfg, scfg, seq_len=seq_len, batch=batch,
                            device=device)


def test_sound_training_run_is_correct():
    out = _train()
    assert out["correct"] is True, out["check"]


@pytest.mark.parametrize("fault", [_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_training_faults_are_caught(fault):
    out = _train(fault)
    assert out["correct"] is False, out["check"]


CLIENTS = 8      # one slot of eight wrong is an eighth of the rows


def _prefill(conf, wrap=None):
    workload = {smoke.mamba2: "mamba2.prefill",
                smoke.granite: "granite-moe.prefill"}[conf]
    spec = smoke.spec(workload, conf(),
                      dict(smoke.prefill_mix(), clients=CLIENTS))

    def make_step(cfg, scfg, *, seq_len, batch, device):
        step = cells._default_prefill_step(cfg, scfg, seq_len=seq_len,
                                           batch=batch, device=device)
        return step if wrap is None else wrap(step, batch)
    run = harness.run_cell(spec, SEED, 0.5, False, CPU, 0.0,
                           make_step=make_step)
    return harness.result(spec, run, False, {"platform": "cpu"})


def _token_altered(step, batch):
    def f(params, b, cache):
        logits, cache = step(params, b, cache)
        return logits.roll(1, dims=-1), cache     # argmax moves by one
    return f


def _one_slot_altered(step, batch):
    def f(params, b, cache):
        logits, cache = step(params, b, cache)
        logits = logits.clone()
        logits[-1] = logits[-1].roll(1, dims=-1)   # the last slot only
        return logits, cache
    return f


def _half_rows(step, batch):
    half = {}

    def f(params, b, cache):
        n = b["tokens"].shape[1]
        if n not in half:
            half[n] = cells._default_prefill_step(
                params.cfg, _scfg(), seq_len=n, batch=batch // 2,
                device=CPU)
        from repro_torch.launch.steps import make_cache
        c = make_cache(params.cfg, _scfg(), batch=batch // 2, max_len=n,
                       device=CPU)
        logits, _ = half[n](params, {"tokens": b["tokens"][:batch // 2]}, c)
        return torch.cat([logits, logits]), cache
    return f


def _scfg():
    from repro_torch.launch.steps import StepConfig
    return StepConfig(param_dtype="bfloat16", cache_dtype="bfloat16")


def _stale(step, batch):
    last = {}

    def f(params, b, cache):
        logits, cache = step(params, b, cache)
        out = last.get("logits", logits)
        last["logits"] = logits
        return out, cache
    return f


@pytest.mark.parametrize("conf", [smoke.mamba2, smoke.granite],
                         ids=["mamba2", "granite_moe"])
def test_sound_prefill_run_is_correct(conf):
    out = _prefill(conf)
    assert out["correct"] is True, out["check"]


@pytest.mark.parametrize("wrap", [_token_altered, _one_slot_altered,
                                  _half_rows, _stale],
                         ids=["token_altered", "one_slot_altered",
                              "half_batch", "state_unchanged"])
@pytest.mark.parametrize("conf", [smoke.mamba2, smoke.granite],
                         ids=["mamba2", "granite_moe"])
def test_prefill_faults_are_caught(conf, wrap):
    out = _prefill(conf, wrap)
    assert out["correct"] is False, out["check"]
