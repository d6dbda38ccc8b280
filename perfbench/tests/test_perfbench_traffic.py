"""The traffic generator: the same seed gives the same requests, every
seed the same lengths in another order, medians as the mix states."""
import numpy as np
import pytest

from perfbench import traffic as gen
from perfbench.tests.tiny import traffic


@pytest.mark.parametrize("mix", ["conversation-closed64", "code-poisson"])
def test_same_seed_same_requests_other_seed_same_lengths(mix):
    t = traffic(mix)
    a = gen.requests(t, 2 ** 31 + 12345, 49152, 4096)
    b = gen.requests(t, 2 ** 31 + 12345, 49152, 4096)
    c = gen.requests(t, 7, 49152, 4096)
    assert all(np.array_equal(x.prompt, y.prompt) and x.max_new == y.max_new
               for x, y in zip(a, b))
    lens = lambda rs: sorted((len(r.prompt), r.max_new) for r in rs)
    assert lens(a) == lens(c)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in c]
    assert all(len(r.prompt) + r.max_new <= 4096 for r in a)
    assert all(0 <= r.prompt.min() and r.prompt.max() < 49152 for r in a)


@pytest.mark.parametrize("mix", ["conversation-closed64", "code-poisson"])
def test_medians_and_clips_are_the_mix_s(mix):
    t = traffic(mix)
    rs = gen.requests(t, 99, 1000, 4096)
    p = np.array([len(r.prompt) for r in rs])
    o = np.array([r.max_new for r in rs])
    assert abs(np.median(p) - t["prompt"]["median"]) <= 1
    assert abs(np.median(o) - t["output"]["median"]) <= 1
    assert p.min() == t["prompt"]["min"] and p.max() == t["prompt"]["max"]
    assert o.min() >= t["output"]["min"] and o.max() <= t["output"]["max"]


def test_arrivals_same_count_and_span_every_seed():
    t = traffic("code-poisson")
    a = gen.arrivals(t, 3, 1000, 4096, 51)
    b = gen.arrivals(t, 2 ** 31 + 5, 1000, 4096, 51)
    assert len(a) == len(b) == round(t["rate_per_s"] * (t["warmup_s"] + 51))
    due = [r.due for r in a]
    assert due == sorted(due) and due[0] >= -t["warmup_s"]
    assert due[-1] < 51
    assert due == [r.due for r in b]          # one arrival trace
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    # a Poisson process: exponential gaps (median ln 2 / rate, as wide as
    # their mean) and counts a second as wide as their mean, bursts kept
    times = gen.poisson_times(np.random.default_rng(2 ** 31 + 9), 20000,
                              2000.0)
    g = np.diff(times)
    assert np.median(g) == pytest.approx(np.log(2) * 0.1, rel=0.05)
    assert g.std() / g.mean() == pytest.approx(1.0, rel=0.05)
    counts = np.bincount(times.astype(int), minlength=2000)
    assert counts.var() / counts.mean() == pytest.approx(1.0, abs=0.1)


def test_balanced_order_spreads_every_stratum():
    rng = np.random.default_rng(4)
    keys = np.arange(64)[::-1]
    order = gen.balanced_order(rng, keys)
    assert sorted(order) == list(range(64))
    ranks = np.argsort(np.argsort(keys))[order]
    for b in range(8):
        assert sorted(ranks[8 * b:8 * b + 8] // 8) == list(range(8))
    assert list(order) != list(gen.balanced_order(np.random.default_rng(5),
                                                  keys))
