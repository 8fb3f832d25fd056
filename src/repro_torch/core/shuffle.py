"""Distributed joins (paper §5.1–5.2): GHJ, GHJ+Bloom, RDMA-GHJ, RRJ, in
PyTorch.

The port of ``repro.core.shuffle``.  All four share the same local
building blocks (radix partition + sort-probe join), so measured
differences isolate the shuffle strategy, as in the paper's Fig 8(a).  The
shuffle itself is ``transport.route()``: on the card its slot assignment
and its scatter are the hand-written ``radix_partition`` kernels.  The RDMA
variants route with ``chunks = 4``.  The local radix passes keep their
stable-sort form (``torch.sort(stable=True)``).

Relations are (keys, values) of u32 words carried as int32 bit patterns
(:mod:`repro_torch._bits`); R is the unique-key build side.  Keys are
ordered and hashed as u32 (int64 after ``& 0xFFFFFFFF``), so ``MISS``
(0xFFFFFFFF, int32 -1) sorts last.  ``join_agg`` is a u32 sum of u32
products, wrapping at 2**32 as the JAX package's does with x64 off.
"""
from __future__ import annotations

import torch

from repro_torch._bits import mul32, to_i32, u32
from repro_torch.core import bloom as bloom_mod

MISS = -1                   # 0xFFFFFFFF as int32: filtered / empty slot
JOIN_VARIANTS = ("ghj", "ghj_bloom", "rdma_ghj", "rrj")


def _parts(keys, num_parts: int, bits_from: int) -> torch.Tensor:
    """u32 ``(keys >> bits_from) % num_parts`` as int32 (a logical shift)."""
    return ((u32(keys) >> bits_from) % num_parts).to(torch.int32)


def _radix_order(keys, num_parts: int, bits_from: int = 0) -> torch.Tensor:
    """The stable order of one radix pass."""
    return torch.sort(_parts(keys, num_parts, bits_from), stable=True)[1]


def radix_partition(keys, num_parts: int, *, bits_from: int = 0):
    """Partition ids + stable order for a radix pass.
    Returns (part_id (N,) int32, order (N,) int64, counts (P,) int32)."""
    part = _parts(keys, num_parts, bits_from)
    order = torch.sort(part, stable=True)[1]
    counts = torch.bincount(part, minlength=num_parts).to(torch.int32)
    return part, order, counts


def local_join(rk, rv, sk, sv):
    """Join unique-key build side R with probe side S, in u32 key order.
    Returns (matched mask (|S|,), r-values aligned to S (|S|,))."""
    rks, order = torch.sort(u32(rk), stable=True)
    rvs = rv[order]
    sk64 = u32(sk)
    pos = torch.searchsorted(rks, sk64).clamp(0, rks.shape[0] - 1)
    hit = rks[pos] == sk64
    return hit, torch.where(hit, rvs[pos], 0)


def _cache_blocks(keys, vals, num_blocks: int):
    """Radix pass 2: bin into cache-sized blocks (software-managed
    buffers)."""
    order = _radix_order(keys, num_blocks, bits_from=16)
    return keys[order], vals[order]


def join_agg(hit, rv, sv) -> torch.Tensor:
    """Benchmark payload: the u32 sum of matched u32 value products (forces
    the join).  A 0-dim int32 bit pattern."""
    prod = mul32(u32(rv), u32(sv))
    return to_i32(torch.where(hit, prod, 0).sum())


# -------------------------------------------------------- single-node -----

def ghj_local(rk, rv, sk, sv, *, num_parts: int = 32,
              use_bloom: bool = False, bloom_bits: int = 1 << 20):
    """Grace hash join on one shard (partition -> per-partition join).
    With use_bloom, S is pre-filtered by a Bloom filter on R's keys."""
    if use_bloom:
        bits = bloom_mod.build(rk, bloom_bits)
        keep = bloom_mod.query(bits, sk)
        # fixed-shape filter: drop misses by pointing them at a sentinel key
        sk = torch.where(keep, sk, MISS)
    orderR = _radix_order(rk, num_parts)
    orderS = _radix_order(sk, num_parts)
    rk2, rv2 = _cache_blocks(rk[orderR], rv[orderR], num_parts)
    sk2, sv2 = _cache_blocks(sk[orderS], sv[orderS], num_parts)
    hit, rvals = local_join(rk2, rv2, sk2, sv2)
    return join_agg(hit, rvals, sv2)


def rrj_local(rk, rv, sk, sv, *, num_blocks: int = 64):
    """RRJ collapses GHJ's network partition + radix pass into ONE radix
    pass straight into cache-sized remote buffers (paper §5.2)."""
    orderR = _radix_order(rk, num_blocks)
    orderS = _radix_order(sk, num_blocks)
    hit, rvals = local_join(rk[orderR], rv[orderR], sk[orderS], sv[orderS])
    return join_agg(hit, rvals, sv[orderS])


# --------------------------------------------------------- distributed ----

def _route_by_key(transport, keys, vals, cap: int, chunks: int = 1):
    """Shuffle (keys, vals) to owner shard ``key % n`` through the router;
    MISS keys are filtered, empty slots come back as MISS.
    Returns (keys, vals, dropped) — dropped = rows lost to cap overflow."""
    n = transport.n
    dest = (u32(keys) % n).to(torch.int32)
    dest = torch.where(keys == MISS, n, dest)          # filtered, not dropped
    res = transport.route({"k": keys, "v": vals}, dest, cap=cap,
                          chunks=chunks)
    k = torch.where(res.valid > 0, res.fields["k"], MISS)
    return k, res.fields["v"], res.dropped


def make_distributed_join(transport, variant: str, *,
                          num_parts: int = 32, bloom_bits: int = 1 << 20,
                          capacity_factor: float = 2.0,
                          return_stats: bool = False):
    """variant in :data:`JOIN_VARIANTS`.  Returns f(rk, rv, sk, sv) -> the
    u32 join aggregate (0-dim int32), or (aggregate, dropped rows) with
    ``return_stats=True``.  Capacity is ``capacity_factor/n`` of each
    relation per destination shard; rows beyond it are dropped and the
    result undercounts."""
    if variant not in JOIN_VARIANTS:
        raise ValueError(f"variant {variant!r} not in {JOIN_VARIANTS}")
    n = transport.n

    def body(rk, rv, sk, sv):
        if variant == "ghj_bloom":
            # a bloom over R's keys, combined across shards (OR), filters S
            # before the shuffle (semi-join reduction §5.1.2)
            bits = bloom_mod.build(rk, bloom_bits)
            bits = transport.psum(bits.to(torch.int32)) > 0
            keep = bloom_mod.query(bits, sk)
            sk = torch.where(keep, sk, MISS)
        chunks = 4 if variant in ("rdma_ghj", "rrj") else 1
        cap_r = int(rk.shape[0] * capacity_factor / n) // chunks * chunks
        cap_s = int(sk.shape[0] * capacity_factor / n) // chunks * chunks
        rk2, rv2, drop_r = _route_by_key(transport, rk, rv, cap_r,
                                         chunks=chunks)
        sk2, sv2, drop_s = _route_by_key(transport, sk, sv, cap_s,
                                         chunks=chunks)
        if variant == "rrj":
            agg = rrj_local(rk2, rv2, sk2, sv2, num_blocks=num_parts)
        else:
            agg = ghj_local(rk2, rv2, sk2, sv2, num_parts=num_parts)
        return transport.psum(agg), transport.psum(drop_r + drop_s)

    def f(rk, rv, sk, sv):
        agg, dropped = transport.run(body, (rk, rv, sk, sv),
                                     out_reps=(True, True))
        return (agg, dropped) if return_stats else agg

    return f
