"""The traffic generator is a pure function of the seed, and every seed gets
the same sizes and gaps in another order."""

import numpy as np
import torch

from perfbench import traffic

MIX = {"requests": 300, "block": 64,
       "prompt": {"kind": "log_uniform", "min": 512, "max": 2048},
       "output": {"kind": "uniform", "min": 256, "max": 1024},
       "arrivals": {"kind": "poisson", "rate": 5.0}}


def test_same_seed_same_requests():
    a, b = traffic.make(MIX, 32768, 2**31 + 5), traffic.make(MIX, 32768, 2**31 + 5)
    assert [(r.max_tokens, r.due, r.prompt.tolist()) for r in a] == \
           [(r.max_tokens, r.due, r.prompt.tolist()) for r in b]


def test_seeds_share_sizes_and_gaps_per_block():
    a, b = traffic.make(MIX, 32768, 11), traffic.make(MIX, 32768, 12)
    for lo in range(0, 256, 64):
        blk = slice(lo, lo + 64)
        assert sorted(len(r.prompt) for r in a[blk]) == sorted(len(r.prompt) for r in b[blk])
        assert sorted(r.max_tokens for r in a[blk]) == sorted(r.max_tokens for r in b[blk])
    assert [len(r.prompt) for r in a[:64]] != [len(r.prompt) for r in b[:64]]
    gaps = [np.diff([r.due for r in x[:65]]) for x in (a, b)]
    ga = np.diff([r.due for r in a[:129]])[:64]
    gb = np.diff([r.due for r in b[:129]])[:64]
    assert abs(ga.sum() - gb.sum()) < 1e-9 and gaps[0].shape == gaps[1].shape


def test_lengths_in_range_and_log_uniform_mean():
    reqs = traffic.make(MIX, 32768, 3)
    lens = np.array([len(r.prompt) for r in reqs[:256]])
    outs = np.array([r.max_tokens for r in reqs[:256]])
    assert lens.min() >= 512 and lens.max() <= 2048
    assert outs.min() >= 256 and outs.max() <= 1024
    assert abs(lens.mean() - (2049 - 512) / np.log(2049 / 512)) < 15
    assert abs(outs.mean() - 640.5) < 4
    assert all(0 <= t < 32768 for r in reqs[:10] for t in r.prompt)


def test_first_round_requests_are_caught_in_flight():
    """A first-round request's prompt holds the part of its answer already
    produced: its context fits a prompt and an answer, and every seed gets
    the same remaining lengths and contexts in another order."""
    mix = {"requests": 256, "block": 128, "first_round": 128, "prompt": MIX["prompt"],
           "output": MIX["output"]}
    a, b = traffic.make(mix, 32768, 2**31 + 21), traffic.make(mix, 32768, 2**31 + 22)
    for reqs in (a, b):
        first, rest = reqs[:128], reqs[128:]
        assert all(1 <= r.max_tokens <= 1024 for r in first)
        assert all(512 <= len(r.prompt) and len(r.prompt) + r.max_tokens <= 2048 + 1024
                   for r in first)
        # length-biased: a request in flight is longer than one drawn at its start
        assert np.mean([len(r.prompt) for r in first]) > np.mean([len(r.prompt) for r in rest]) + 200
    assert sorted(r.max_tokens for r in a[:128]) == sorted(r.max_tokens for r in b[:128])
    assert [r.max_tokens for r in a[:128]] != [r.max_tokens for r in b[:128]]
    assert sum(len(r.prompt) for r in a[:128]) == sum(len(r.prompt) for r in b[:128])


def test_mean_gap_is_the_rate():
    reqs = traffic.make({**MIX, "requests": 128}, 100, 9)
    assert abs(reqs[-1].due / 127 - 1 / 5.0) < 0.02


def test_train_batches_pure_and_rows_differ():
    a = traffic.train_batch(7, 2, 4, 64, 1000, "cpu")
    b = traffic.train_batch(7, 2, 4, 64, 1000, "cpu")
    c = traffic.train_batch(7, 3, 4, 64, 1000, "cpu")
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    assert torch.equal(a[1], torch.roll(a[0], -1, dims=1))
    assert len({tuple(r.tolist()) for r in a[0]}) == 4
