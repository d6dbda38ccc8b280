"""The one traffic generator: reads a mix's parameters, draws from --seed.

Every seed gets the same lengths in another order. Prompt and output
lengths are a fixed set of lognormal quantiles (stratified: ``n`` evenly
spaced quantiles of the mix's median and sigma, clipped), paired once by
a fixed shuffle; a seed orders the pairs and draws the token ids. The
seed's order of lengths is balanced (:func:`balanced_order`): every
``block`` consecutive requests hold one prompt length from each
``block``-quantile of the set, so a run's window holds nearly the same
mix of lengths on every seed.

Open loops replay one arrival trace, the same for every seed: a draw of a
Poisson process over the span from ``warmup_s`` before the window to its
close, given its count (``rate_per_s`` times the span, at independent
uniform times; :func:`poisson_times`), from a fixed generator. Its gaps
are a Poisson process's, bursts included. The seed orders the requests
that arrive at those times: drawn from the seed, the arrival times made
one seed's TTFT tail a quarter off another's, wider than any bound the
benchmark can keep. Imports nothing of the program.
"""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

_PAIRING_SEED = 20231118        # fixes which prompt length goes with which
                                # output length, and the open loops'
                                # arrival trace, for every seed alike


def lognormal_quantiles(n: int, median: float, sigma: float, lo: int,
                        hi: int) -> np.ndarray:
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(
        np.int64)


def balanced_order(rng, keys, block: int = 8) -> np.ndarray:
    """A permutation of ``range(len(keys))`` whose every ``block``
    consecutive positions take one index from each of ``block`` strata of
    ``keys`` (by rank), drawn without replacement in ``rng``'s order."""
    strata = [list(rng.permutation(s)) for s in
              np.array_split(np.argsort(keys, kind="stable"), block)]
    out = []
    while any(strata):
        out += [int(i) for i in rng.permutation([s.pop() for s in strata
                                                 if s])]
    return np.asarray(out)


def poisson_times(rng, n: int, span: float) -> np.ndarray:
    """The arrival times of a Poisson process over ``[0, span)`` given
    that ``n`` arrivals fall in it: ``n`` independent uniform times,
    sorted."""
    return np.sort(rng.uniform(0.0, span, n))


@dataclass
class Req:
    """One request of the mix: prompt ids, output tokens asked for, and
    (open loop) when it is due, in seconds from the window's opening."""
    index: int
    prompt: np.ndarray
    max_new: int
    due: float = 0.0


def length_pairs(mix: dict, max_len: int) -> np.ndarray:
    """The mix's fixed ``(prompt, output)`` pairs, ``mix["requests"]`` of
    them, the output cut so that the two fit into ``max_len``."""
    n = int(mix["requests"])
    p, o = mix["prompt"], mix["output"]
    prompts = lognormal_quantiles(n, p["median"], p["sigma"], p["min"],
                                  p["max"])
    outs = lognormal_quantiles(n, o["median"], o["sigma"], o["min"],
                               o["max"])
    outs = outs[np.random.default_rng(_PAIRING_SEED).permutation(n)]
    outs = np.minimum(outs, max_len - prompts)
    if (outs < 1).any():
        raise ValueError("a prompt leaves no room for its output within "
                         "max_len")
    return np.stack([prompts, outs], 1)


def requests(mix: dict, seed: int, vocab: int, max_len: int) -> list:
    """Every request of the mix for ``seed``, in sending order."""
    rng = np.random.default_rng([int(seed), 1])
    pairs = length_pairs(mix, max_len)
    pairs = pairs[balanced_order(rng, pairs[:, 0])]
    return [Req(i, rng.integers(0, vocab, size=int(pl), dtype=np.int32),
                int(ol)) for i, (pl, ol) in enumerate(pairs)]


def arrivals(mix: dict, seed: int, vocab: int, max_len: int,
             seconds: float) -> list:
    """The open loop's requests: due from ``-warmup_s`` until the window
    closes at ``seconds``, Poisson at ``rate_per_s``, at the same times
    for every seed. Requests beyond the mix's list start it again."""
    rate, warm = float(mix["rate_per_s"]), float(mix["warmup_s"])
    span = warm + seconds
    n = max(int(round(rate * span)), 1)
    due = poisson_times(np.random.default_rng([_PAIRING_SEED, 2]), n,
                        span) - warm
    reqs = requests(mix, seed, vocab, max_len)
    return [Req(i, reqs[i % len(reqs)].prompt, reqs[i % len(reqs)].max_new,
                float(due[i])) for i in range(n)]
