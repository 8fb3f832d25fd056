"""Distributed aggregation (paper §5.3, Fig 8b), in PyTorch.

The port of ``repro.core.aggregation``.  Dist-AGG (classic hierarchical):
local aggregate -> global union -> post-aggregate; its cost grows with the
distinct count.  RDMA-AGG: per-chunk pre-aggregation into per-owner
partition tables, flushed through ``transport.route()`` (dest = owner
shard, chunked exchange = the background flush), then each owner
post-aggregates its slice.

Every sum is u32 and wraps at 2**32, as the JAX package's "uint64" sums
do with x64 off; keys and values are u32 words as int32 bit patterns
(:mod:`repro_torch._bits`).  Every scatter-add runs through
:func:`repro_torch.kernels.ops.grouped_sum_u32_by_key`, which takes the
u32 keys and computes each row's slot inside the hand-written
``grouped_agg`` kernel on the card (its plain version builds the slot in
torch on the CPU, or with the transport's ``impl="plain"``): ``key % G``
here, RDMA-AGG's (chunk, owner, group) layout in its phase 1.
"""
from __future__ import annotations

import torch

from repro_torch._bits import to_i32, u32
from repro_torch.kernels import ops
from repro_torch.spans import span


def segment_sum_by_key(keys, vals, num_slots: int, *, impl=None):
    """(num_slots,) u32 per-slot sums of ``vals`` by ``keys % num_slots``."""
    return ops.grouped_sum_u32_by_key(keys, vals, num_slots, impl=impl)


def preagg_table(keys, vals, table_slots: int, *, impl=None):
    """Cache-sized direct-mapped pre-aggregation: colliding keys merge (the
    benchmark aggregates by hashed group).  Returns the (table_slots,)
    table."""
    return ops.grouped_sum_u32_by_key(keys, vals, table_slots, impl=impl)


def dist_agg(transport, num_groups: int):
    """Classic hierarchical aggregation.  Returns f(keys, vals) -> dense
    (num_groups,) u32 sums (group = key hash)."""

    def body(keys, vals):
        with span("agg.preagg"):                              # phase 1
            local = segment_sum_by_key(keys, vals, num_groups,
                                       impl=transport.impl)
        # global union + post-aggregation on every node
        with span("agg.flush"):                               # phase 2
            return transport.psum(local)

    return lambda keys, vals: transport.run(body, (keys, vals),
                                            out_reps=True)


def rdma_agg(transport, num_groups: int, *, chunks: int = 4):
    """RDMA-optimized aggregation.  Groups are hash-partitioned across
    shards (owner = slot // (groups/n)); each chunk pre-aggregates into
    per-owner tables that stream to their owners through the router, and
    each owner post-aggregates only its slice."""
    n = transport.n
    if not (num_groups % n == 0 or num_groups < n):
        raise ValueError(f"num_groups={num_groups} not a multiple of the "
                         f"{n} shards")

    def body(keys, vals):
        gsz = max(num_groups // n, 1)
        N = keys.shape[0]
        if N % chunks:
            raise ValueError(f"{N} rows do not split into {chunks} chunks")
        # phase 1: per-chunk pre-aggregation into the owner layout — one
        # (n, gsz) partition table per chunk, ONE scatter-add whose slot
        # (ci * n + owner) * gsz + slot % gsz the kernel computes per key
        with span("agg.preagg"):
            part = ops.grouped_sum_u32_by_key(keys, vals, num_groups,
                                              chunks=chunks, n=n,
                                              impl=transport.impl)
        # background flush: route each chunk's n owner tables (dest = owner,
        # cap = chunks, chunked exchange pipelines the transfer)
        with span("agg.flush"):
            tabs = part.view(chunks * n, gsz)
            dest = torch.arange(n, dtype=torch.int32,
                                device=keys.device).repeat(chunks)
            res = transport.route({"tab": tabs}, dest, cap=chunks,
                                  chunks=chunks)
        # phase 2: post-aggregation of my slice only, wrapping at 2**32
        with span("agg.post"):
            live = (res.valid > 0)[:, None]
            mine = to_i32(torch.where(live, u32(res.fields["tab"]),
                                      0).sum(0))
            return transport.all_gather(mine)[:num_groups]

    return lambda keys, vals: transport.run(body, (keys, vals),
                                            out_reps=True)
