"""The traffic generators are functions of the seed."""

import itertools

import numpy as np
import pytest

from pb.common import load_module
from small import small

BIG = 2 ** 31 + 12345


def batches(gen, n=3, seed=BIG):
    return list(itertools.islice(gen.stream(seed, 1, "b"), n))


@pytest.mark.parametrize("cell", ["r2gen224.batch.lenmix", "cmn224.batch.full100"])
def test_serving_streams_repeat_from_the_seed(cell):
    _, cfg, traffic = small(cell)
    mod = load_module("generators", traffic["generator"])
    a, b = mod.make(traffic, cfg, BIG), mod.make(traffic, cfg, BIG)
    for x, y in zip(batches(a), batches(b)):
        assert x.keys() == y.keys()
        for k in x:
            assert np.array_equal(np.asarray(x[k]), np.asarray(y[k])), k
    c = mod.make(traffic, cfg, BIG + 1)
    assert not np.array_equal(a.pool[0]["images"], c.pool[0]["images"])


def test_lengths_follow_the_mix():
    _, cfg, traffic = small("r2gen224.batch.lenmix")
    gen = load_module("generators", "serving_studies").make(traffic, cfg, 3)
    lo, hi = traffic["report_words"]["clip"]
    lengths = np.concatenate([b["target_len"] for b in batches(gen, 20, 3)])
    assert lengths.min() >= lo and lengths.max() <= hi
    assert np.array_equal(lengths, np.concatenate([b["_aux"] for b in batches(gen, 20, 3)]))
    other = np.concatenate([b["target_len"] for b in batches(gen, 20, 4)])
    assert not np.array_equal(lengths, other)


def test_layout_anchors_then_views():
    _, cfg, traffic = small("r2gen224.batch.lenmix")
    gen = load_module("generators", "serving_studies").make(traffic, cfg, 3)
    n, cycle = gen.n, traffic["aux_views_cycle"]
    assert list(gen.pids[:n]) == list(range(n))
    views = gen.pids[n:]
    assert [int((views == r).sum()) for r in range(n)] == [cycle[r % len(cycle)]
                                                           for r in range(n)]
    got = gen.study_inputs(0, [2])
    assert list(got["pids"]) == [2] * (1 + cycle[2 % len(cycle)])
