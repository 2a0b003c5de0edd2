"""The general traffic generator: a mix's parameters and a seed in,
requests or training batches out.

Every seed gets the same work in another order. Lengths are stratified
quantiles of the mix's distribution, ``block`` of them at a time, dealt
into groups of ``clients`` by one fixed shuffle that every seed shares: a
closed loop of ``clients`` clients serves one such group an epoch, so
every seed serves the same epochs. The seed orders the groups and the
requests within each, and draws the token ids.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import numpy as np


def stratified(dist: Dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles (i + 1/2) / n of ``dist``:
    ``{"dist": "loguniform" | "uniform", "lo", "hi"}``, rounded up to a
    multiple of ``dist["multiple"]`` when it is given, else to the
    nearest integer, and kept within [lo, hi] after rounding up."""
    lo, hi = float(dist["lo"]), float(dist["hi"])
    u = (np.arange(n) + 0.5) / n
    if dist["dist"] == "loguniform":
        v = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    elif dist["dist"] == "uniform":
        v = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    mult = int(dist.get("multiple", 0))
    if mult:
        v = np.ceil(v / mult) * mult
        top = math.ceil(hi / mult) * mult
    else:
        v = np.rint(v)
        top = hi
    return np.clip(v, lo, top).astype(np.int64)


def longest(dist: Dict) -> int:
    """The largest length ``dist`` gives."""
    mult = int(dist.get("multiple", 0))
    return int(math.ceil(dist["hi"] / mult) * mult if mult else dist["hi"])


def requests(mix: Dict, seed: int, vocab: int
             ) -> Iterator[Tuple[np.ndarray, int]]:
    """Endless (prompt token ids [S] int64, output tokens) pairs of a
    serving mix, one block of ``mix["block"]`` at a time: the block's
    groups of ``mix["clients"]`` in an order drawn from the seed."""
    n, g = int(mix["block"]), int(mix["clients"])
    if n % g:
        raise ValueError(f"block {n} is not whole groups of {g} clients")
    deal = np.random.default_rng(0)          # the grouping every seed shares
    plen = deal.permutation(stratified(mix["prompt_tokens"], n))
    olen = deal.permutation(stratified(mix["output_tokens"], n))
    b = 0
    while True:
        rng = np.random.default_rng([seed, b])
        for k in rng.permutation(n // g):
            for j in k * g + rng.permutation(g):
                yield (rng.integers(0, vocab, int(plen[j]), dtype=np.int64),
                       int(olen[j]))
        b += 1


def warmup_requests(mix: Dict, seed: int, vocab: int, n: int
                    ) -> List[Tuple[np.ndarray, int]]:
    """``n`` requests at the mix's longest prompt and output: the shape a
    warm-up epoch has to reach."""
    rng = np.random.default_rng([seed, -1 % (1 << 32)])
    S, O = longest(mix["prompt_tokens"]), longest(mix["output_tokens"])
    return [(rng.integers(0, vocab, S, dtype=np.int64), O)
            for _ in range(n)]


def pipeline_tokens(seed: int, batch: int, seq_len: int, vocab: int,
                    shard: int, step: int) -> Tuple[np.ndarray, np.ndarray]:
    """The training stream's (tokens, targets) [batch, seq_len] int32 of
    one step: a periodic and Markov mixture from numpy's ``default_rng``,
    a copy of the rule of the port's ``TokenPipeline`` (``data/pipeline.py``)
    kept here so that the reference works the batches out again."""
    rng = np.random.default_rng((seed * 1_000_003 + shard) * 65_537 + step)
    B, S, V = batch, seq_len, vocab
    base = rng.integers(0, V, size=(B, 1), dtype=np.int32)
    drift = rng.integers(1, 7, size=(B, 1), dtype=np.int32)
    pos = np.arange(S + 1, dtype=np.int32)[None, :]
    seq = (base + drift * pos) % V
    noise_mask = rng.random((B, S + 1)) < 0.1
    noise = rng.integers(0, V, size=(B, S + 1), dtype=np.int32)
    seq = np.where(noise_mask, noise, seq).astype(np.int32)
    return seq[:, :-1], seq[:, 1:]
