"""The controls: the plain reference put in the program's place in the
precision below the one the configuration states.  At the cells' own
size the readings come from ``calibrate.py`` on the chip; here, at a
size a test run holds, the control reads above the program."""

import pytest
import torch

from perfbench import cells, harness
from perfbench.sizes import sizes
from perfbench.tests import smoke
from perfbench.traffic.gen import PrefillStream

SEED = 2 ** 31 + 99


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("conf", [smoke.mamba2, smoke.granite],
                         ids=["mamba2", "granite_moe"])
def test_fp8_control_reads_above_the_program(conf):
    mix = dict(smoke.prefill_mix(), clients=16, checked_batches=8)
    workload = {smoke.mamba2: "mamba2.prefill",
                smoke.granite: "granite-moe.prefill"}[conf]
    spec = smoke.spec(workload, conf(), mix)
    dev = torch.device("cpu")
    run = harness.run_cell(spec, SEED, 1.0, False, dev, 0.0)
    s = sizes(spec["conf"])
    picked = run.notes["checked_batches"]
    ctrl = cells.served_readings(s, mix, SEED, dev,
                                 PrefillStream(mix, SEED, s.token_ids),
                                 picked, {}, precision="fp8")
    assert len(ctrl["err"]) == run.notes["checked_requests"]
    # the control has to read far above the program on one of the
    # numbers: at this size granite's bf16 routing already flips a
    # token's experts, which moves a row by up to one of its spread
    got = cells.prefill_numbers(ctrl)
    ratio = max(got[k] / max(run.numbers[k], 1e-9)
                for k in spec["limits"]["numbers"])
    assert ratio > 3


@pytest.mark.gpu
def test_tf32_control_reads_above_the_program(cuda):
    spec = smoke.spec("granite-moe.train", smoke.granite(), smoke.train_mix())
    run = harness.run_cell(spec, SEED, 0.0, False, cuda, 0.0)
    s, mix = sizes(spec["conf"]), spec["mix"]
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = cells.reference_train(s, mix, SEED, cuda)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ctrl = cells.train_numbers(tf32, run.readings["reference"])
    # TF32 moves every slice of the first gradient; at the cell's size the
    # port's routing swaps reach the leaves' norms as far (PERF.md)
    assert ctrl["grad1_slice_q10"] > 3 * run.numbers["grad1_slice_q10"]
