"""Seeded draws: the order of a closed loop's requests, Zipf popularity,
and rows of distinct ids.

``zipf_weights`` is a copy of ``repro_torch.bench.workloads.zipf_weights``
(rank 1 is id 0, the hottest).  Every seed gets the same mix of request
kinds: :class:`Blocks` deals whole blocks, so seeds differ in order and
data, never in the amount of work.
"""
from __future__ import annotations

import numpy as np


def seed_words(seed: int) -> int:
    """A seed folded into the 63 bits a ``torch.Generator`` takes."""
    return int(seed) & ((1 << 63) - 1)


class Blocks:
    """An endless closed loop's request kinds in [0, ``kinds``): each
    block of ``kinds`` requests holds every kind once, in an order drawn
    from ``seed`` when the block starts."""

    def __init__(self, kinds: int, seed: int):
        self.kinds = int(kinds)
        self.rng = np.random.default_rng(seed)
        self.block, self.at = (), self.kinds

    def next(self) -> int:
        if self.at == self.kinds:
            self.block, self.at = self.rng.permutation(self.kinds), 0
        self.at += 1
        return int(self.block[self.at - 1])


def zipf_weights(n: int, s: float) -> np.ndarray:
    """Normalized Zipf pmf over ranks 1..n: P(rank r) ∝ r^-s (s = 0 is
    uniform); rank 1 is id 0."""
    n = int(n)
    if n < 1:
        raise ValueError("need at least one key")
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** -float(s)
    return w / w.sum()


def zipf_cdf(n: int, s: float):
    """The cumulative Zipf(``s``) over ``n`` ids, or None for s = 0
    (uniform)."""
    if s <= 0:
        return None
    cdf = np.cumsum(zipf_weights(n, s))
    cdf[-1] = 1.0
    return cdf


def distinct_rows(rows: int, width: int, n: int, cdf,
                  rng: np.random.Generator) -> np.ndarray:
    """(rows, width) int64 ids in [0, n), distinct within each row: each
    id uniform (``cdf`` None) or by the cumulative popularity ``cdf``
    (:func:`zipf_cdf`); a row that draws an id twice is drawn again
    whole."""
    def draw(k: int) -> np.ndarray:
        if cdf is None:
            return rng.integers(0, n, (k, width))
        u = rng.random((k, width))
        return np.minimum(np.searchsorted(cdf, u, side="right"), n - 1)

    out = draw(rows)
    while True:
        s = np.sort(out, axis=1)
        dup = np.flatnonzero((s[:, 1:] == s[:, :-1]).any(1))
        if not dup.size:
            return out
        out[dup] = draw(dup.size)
