"""Smoke-size specs of the benchmark's cells, for the CPU tests: the
configuration files' families at a few dozen channels, and the mixes
at a few short batches."""

import json

from perfbench import harness
from perfbench.sizes import load_config
from perfbench.traffic.gen import load_mix


def granite() -> dict:
    c = load_config("granite-moe-3b-a800m")
    c.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=2, intermediate_size=32,
             num_local_experts=8, num_experts_per_tok=2, vocab_size=128)
    return c


def mamba2() -> dict:
    c = load_config("mamba2-780m")
    c.update(d_model=64, n_layer=2, vocab_size=120)
    c["mamba2_layer_defaults"] = dict(c["mamba2_layer_defaults"],
                                      d_state=16, headdim=16, chunk_size=16)
    return c


def train_mix() -> dict:
    return dict(load_mix("train_4x1024"), global_batch=2, seq_len=64,
                mean_doc_len=16, trace_steps=2)


def prefill_mix() -> dict:
    return dict(load_mix("prefill_pool"), clients=2,
                cycle=[[16, 2], [32, 1], [48, 1]], checked_batches=4,
                trace_batches=4)


# Limits at smoke size, one set a cell, each under the names of the cell's
# own limits file (``limits/<cell>.json``): those hold at the cells' sizes;
# a model of 64 channels rounds its bf16 logits to a spread of errors of
# its own (up to 1 of a row's spread on granite's 8 experts, where a
# token's routing flips), so its served numbers get their own.
SMOKE_LIMITS = {
    "granite-moe.train": {"loss_gap": 1e-4, "grad1_median_gap": 1e-3,
                          "change_gap": 1e-2, "grad1_slice_q10": 1e-3},
    "mamba2.prefill": {"served_gap": 1.5, "logit_err": 2.0},
    "granite-moe.prefill": {"logit_err_median": 0.5, "logit_err_p90": 1.5},
}


def spec(workload: str, conf: dict, mix: dict) -> dict:
    """The cell ``workload`` of ``BENCHMARK.json`` at smoke size, held to
    :data:`SMOKE_LIMITS` of that cell."""
    bench = json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
    cell = harness.cell_spec(bench, workload)
    names = SMOKE_LIMITS[workload]
    assert set(names) == set(cell["limits"]["numbers"]), workload
    limits = {"numbers": {k: {"limit": v} for k, v in names.items()}}
    return dict(cell, conf=conf, mix=mix, limits=limits)
