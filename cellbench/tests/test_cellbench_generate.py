"""The traffic generator: the same work for every seed, in another order."""
import itertools

import numpy as np
import pytest

from cellbench.generate import (longest, pipeline_tokens, requests,
                                stratified)

MIX = {"clients": 4, "block": 16,
       "prompt_tokens": {"dist": "loguniform", "lo": 64, "hi": 512,
                         "multiple": 64},
       "output_tokens": {"dist": "loguniform", "lo": 2, "hi": 9}}


def test_stratified_by_hand():
    v = stratified({"dist": "uniform", "lo": 0, "hi": 10}, 5)
    assert v.tolist() == [1, 3, 5, 7, 9]
    v = stratified(MIX["prompt_tokens"], 8)
    assert all(x % 64 == 0 and 64 <= x <= 512 for x in v)
    assert longest(MIX["prompt_tokens"]) == 512
    assert longest({"lo": 4, "hi": 16}) == 16


def epochs(seed, n=8):
    it = requests(MIX, seed, 1000)
    return [[next(it) for _ in range(MIX["clients"])] for _ in range(n)]


@pytest.mark.parametrize("a,b", [(1, 2), (2**31 + 5, 7)])
def test_every_seed_serves_the_same_epochs(a, b):
    ea, eb = epochs(a), epochs(b)

    def shape(e):
        return sorted(tuple(sorted((len(p), o) for p, o in ep)) for ep in e)
    assert shape(ea[:4]) == shape(eb[:4]) and shape(ea[4:]) == shape(eb[4:])
    assert [len(p) for p, _ in itertools.chain(*ea)] != \
        [len(p) for p, _ in itertools.chain(*eb)]
    assert not np.array_equal(ea[0][0][0][:8], eb[0][0][0][:8])
    with pytest.raises(ValueError):
        next(requests(dict(MIX, block=10), 1, 10))


def test_pipeline_tokens_repeat_per_seed():
    t1, y1 = pipeline_tokens(2**31 + 9, 2, 16, 50, 0, 1)
    t2, y2 = pipeline_tokens(2**31 + 9, 2, 16, 50, 0, 1)
    assert np.array_equal(t1, t2) and np.array_equal(t1[:, 1:], y1[:, :-1])
    assert t1.max() < 50


def test_pipeline_copy_equals_the_ports_pipeline():
    """The reference's batches are the ones the port's TokenPipeline feeds
    the Trainer, worked out again."""
    from repro_torch.data.pipeline import TokenPipeline
    seed = 2**31 + 17
    pipe = TokenPipeline(vocab_size=300, seq_len=32, batch=3, seed=seed)
    for step in range(3):
        got = pipe.next_batch()
        tok, tgt = pipeline_tokens(seed, 3, 32, 300, 0, step)
        assert np.array_equal(got["tokens"].numpy(), tok)
        assert np.array_equal(got["targets"].numpy(), tgt)
