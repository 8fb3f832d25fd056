"""Bloom filter for the semi-join reduction baseline (paper §5.1.2).

The port of ``repro.core.bloom``: the same u32 hash, so :func:`build` and
:func:`query` set and test the same bits as the JAX package.  Keys are
u32 words as int32 bit patterns (:mod:`repro_torch._bits`); the hash runs
on their unsigned values in int64, where ``>>`` is the logical shift of
u32 and every product is taken mod 2**32 by :func:`~repro_torch._bits.mul32`.
"""
from __future__ import annotations

import torch

from repro_torch._bits import M32, mul32, u32

_PRIMES = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1)


def _hash(keys: torch.Tensor, seed: int, m: int) -> torch.Tensor:
    h = (mul32(u32(keys), _PRIMES[seed % len(_PRIMES)])
         + (seed * 0x01000193 & M32)) & M32
    h ^= h >> 15
    h = mul32(h, 0x2C1B3C6D)
    h ^= h >> 12
    return h % m


def build(keys: torch.Tensor, m_bits: int, k: int = 3) -> torch.Tensor:
    """(m_bits,) bool with the k hash bits of every key set."""
    bits = torch.zeros((m_bits,), dtype=torch.bool, device=keys.device)
    for s in range(k):
        bits[_hash(keys, s, m_bits)] = True
    return bits


def query(bits: torch.Tensor, keys: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Per key: whether all k of its bits are set (no false negatives)."""
    m = bits.shape[0]
    out = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    for s in range(k):
        out &= bits[_hash(keys, s, m)]
    return out
