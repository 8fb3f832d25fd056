"""The frozen yardstick: the card's published peaks and the least bytes
each step of a query must move.

A copy, frozen here, of ``repro_torch.core.costmodel.H100``'s peaks and of
the byte bounds of ``chip_smoke.py``'s kernel table: every input byte read
once and every output byte written once, at the HBM's rate.  The work is
reckoned from the step's shapes, never from which kernel did it, so a
later kernel that does the same step is held to the same bound.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def seconds(nbytes: float) -> float:
    """The least time to move ``nbytes`` through HBM."""
    return nbytes / HBM_BYTES_PER_S


def rank_bytes(rows: int, buckets: int) -> int:
    """A route's slot assignment: the (rows,) destinations read, the
    (rows,) int32 slots and two (rows,) bool masks (kept, overflowed)
    written, the (buckets,) counts written."""
    return 4 * rows + 4 * rows + 2 * rows + 4 * buckets


def scatter_bytes(rows: int, lanes: int, slots: int) -> int:
    """A route's scatter: ``rows`` rows of ``lanes`` 32-bit lanes and
    their slots read, the (slots, lanes + 1) wire buffer (the valid lane
    appended) written."""
    return 4 * rows * lanes + 4 * rows + 4 * slots * (lanes + 1)


def agg_bytes(rows: int, slots: int) -> int:
    """A grouped aggregation: the (rows,) u32 keys and values read once,
    the (slots,) u32 table written once."""
    return 8 * rows + 4 * slots


def agg_table_slots(variant: str, groups: int, shards: int = 1,
                    chunks: int = 4) -> int:
    """The table a plan's aggregation fills: Dist-AGG one slot a group;
    RDMA-AGG one (shards, groups / shards) table a chunk (§5.3)."""
    if variant == "dist_agg":
        return groups
    if variant == "rdma_agg":
        return chunks * shards * max(groups // shards, 1)
    raise ValueError(f"unknown aggregation variant {variant!r}")
