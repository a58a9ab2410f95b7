"""The traffic generator: the same seed gives the same inputs, and the
prefill pool's cycles hold the same lengths whatever the seed."""

from collections import Counter

import numpy as np

from perfbench.tests import smoke
from perfbench.traffic.gen import PrefillStream, TrainStream, load_mix

BIG = 2 ** 31 + 987654321


def test_train_stream_is_a_function_of_seed_and_step():
    mix = load_mix("train_4x1024")
    a, b = TrainStream(mix, BIG, 49155), TrainStream(mix, BIG, 49155)
    x, y = a.batch(7), b.batch(7)
    assert x["tokens"].shape == (4, 1024) and x["tokens"].dtype == np.int32
    assert np.array_equal(x["tokens"], y["tokens"])
    assert np.array_equal(x["tokens"][:, 1:], x["labels"][:, :-1])
    assert not np.array_equal(x["tokens"], a.batch(8)["tokens"])
    assert not np.array_equal(
        x["tokens"], TrainStream(mix, BIG + 1, 49155).batch(7)["tokens"])
    assert x["tokens"].min() >= 0 and x["tokens"].max() < 49155
    assert (x["tokens"] == mix["eos_id"]).any()


def test_rows_of_a_step_all_differ():
    rows = TrainStream(load_mix("train_4x1024"), BIG, 49155).batch(0)
    assert len({r.tobytes() for r in rows["tokens"]}) == 4


def test_prefill_cycles_hold_the_mix_in_every_cycle():
    mix = load_mix("prefill_pool")
    want = Counter({n: k for n, k in mix["cycle"]})
    for seed in (0, 17, BIG):
        st = PrefillStream(mix, seed, 50277)
        for c in range(4):
            assert Counter(st.length(10 * c + j) for j in range(10)) == want
    orders = {tuple(PrefillStream(mix, s, 50277).length(j)
                    for j in range(10)) for s in range(8)}
    assert len(orders) > 1


def test_prefill_prompts_are_deterministic():
    mix = load_mix("prefill_pool")
    a, b = PrefillStream(mix, BIG, 50277), PrefillStream(mix, BIG, 50277)
    for i in (0, 3, 11, -1, -4):
        p = a.prompts(i)
        assert p.shape == (8, a.length(i))
        assert np.array_equal(p, b.prompts(i))
        assert p.min() >= 1 and p.max() < 50277
    assert not np.array_equal(a.prompts(0)[:, :1024],
                              PrefillStream(mix, BIG + 1, 50277)
                              .prompts(0)[:, :1024])
    assert sorted(a.length(-1 - j) for j in range(4)) == \
        [1024, 2048, 4096, 8192]


def test_smoke_mix_keeps_the_keys_of_the_real_one():
    assert set(smoke.train_mix()) == set(load_mix("train_4x1024"))
    assert set(smoke.prefill_mix()) == set(load_mix("prefill_pool"))
