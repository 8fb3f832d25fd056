"""Plain PyTorch versions of the port's kernels.

Each function here computes exactly what its CUDA kernel computes, in
ordinary tensor operations, on any device.  The CPU runs them; on the card
``chip_smoke.py`` holds each kernel against them.  All 32-bit words are
int32 bit patterns (:mod:`repro_torch._bits`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._bits import LOCK_BIT, to_i32, u32

_IMAX = 2 ** 31 - 1


def bucket_ranks(dest: torch.Tensor, n: int) -> torch.Tensor:
    """Stable arrival-order rank of each request within its destination
    bucket: cumulative one-hot counts, O(A*n).  A filtered dest (outside
    [0, n)) takes no rank; its returned rank is meaningless."""
    dest = dest.to(torch.int32)
    onehot = dest[:, None] == torch.arange(n, dtype=torch.int32,
                                           device=dest.device)[None, :]
    ranks = torch.cumsum(onehot.to(torch.int32), dim=0,
                         dtype=torch.int32) - 1
    safe = dest.clamp(0, n - 1).to(torch.int64)
    return ranks.gather(1, safe[:, None])[:, 0]


def rank(dest: torch.Tensor, n: int, cap: int):
    """Plain twin of ``radix_partition.rank``: (slot, keep, overflow,
    counts) exactly as ``repro.fabric.router.plan_route`` assigns them."""
    dest = dest.to(torch.int32)
    deliverable = (dest >= 0) & (dest < n)
    r = bucket_ranks(dest, n)
    keep = deliverable & (r < cap)
    overflow = deliverable & (r >= cap)
    slot = torch.where(keep, dest * cap + r,
                       torch.full_like(dest, n * cap))
    counts = torch.zeros((n + 1,), dtype=torch.int32, device=dest.device)
    counts.index_add_(0, torch.where(deliverable, dest, n).to(torch.int64),
                      torch.ones_like(dest))
    return slot, keep, overflow, counts[:n].clamp(max=cap)


def scatter(rows: torch.Tensor, slot: torch.Tensor, num_slots: int, *,
            mask=None, fuse_valid: bool = True) -> torch.Tensor:
    """Plain twin of ``radix_partition.scatter``: rows into a zeroed
    (num_slots, w [+1]) int32 buffer at in-range, unmasked slots."""
    A = rows.shape[0]
    if fuse_valid:
        rows = torch.cat([rows, torch.ones((A, 1), dtype=rows.dtype,
                                           device=rows.device)], dim=1)
    sel = (slot >= 0) & (slot < num_slots)
    if mask is not None:
        sel = sel & mask
    # unsent rows go to one spare row past the buffer, then cut off
    buf = torch.zeros((num_slots + 1, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    buf[torch.where(sel, slot, num_slots).to(torch.int64)] = rows
    return buf[:num_slots]


def radix_partition(vals, bucket, num_buckets: int, cap: int, *,
                    fuse_valid: bool = False):
    """Plain twin of the Pallas ``radix_partition``: rows of 32-bit ``vals``
    into (num_buckets, cap, D [+1]) in arrival order, overflow and buckets
    outside [0, num_buckets) dropped; counts = min(count, cap)."""
    slot, _, _, counts = rank(bucket, num_buckets, cap)
    out = scatter(vals.view(torch.int32), slot, num_buckets * cap,
                  fuse_valid=fuse_valid)
    return out.view(vals.dtype).reshape(num_buckets, cap, -1), counts


def lex_winner(idx, priority, contenders, R: int) -> torch.Tensor:
    """Among ``contenders`` (which must have idx >= 0), mark the single
    request per word that is first in (priority, arrival) order.  The
    table has R+1 slots as in ``repro.fabric.verbs._lex_winner``: slot R
    collects every non-contender, and gathers clamp into it, so a request
    with idx == R can come out marked (callers drop its write)."""
    A = idx.shape[0]
    dev = idx.device
    g = idx.clamp(0, R).to(torch.int64)          # JAX's clamped gather
    seg = torch.where(contenders, idx, R).clamp(max=R + 1).to(torch.int64)
    best_p = torch.full((R + 2,), _IMAX, dtype=torch.int32, device=dev)
    best_p.scatter_reduce_(0, seg, priority, reduce="amin")
    tied = contenders & (priority == best_p[g])
    arrival = torch.arange(A, dtype=torch.int32, device=dev)
    seg2 = torch.where(tied, idx, R).clamp(max=R + 1).to(torch.int64)
    best_i = torch.full((R + 2,), A, dtype=torch.int32, device=dev)
    best_i.scatter_reduce_(0, seg2, arrival, reduce="amin")
    return tied & (arrival == best_i[g])


def cas(words, idx, expected, new, priority) -> torch.Tensor:
    """Plain twin of ``cas_lock.cas`` with ``repro.fabric.verbs.cas``
    semantics: match against the original words (the gather clamps
    idx >= R to R-1), arbitrate with :func:`lex_winner`, winners with
    idx < R install ``new`` in place.  Returns ok (A,) bool."""
    R = words.shape[0]
    cur = words[idx.clamp(0, R - 1).to(torch.int64)]
    match = (cur == expected) & (idx >= 0)
    ok = lex_winner(idx, priority, match, R)
    write = ok & (idx < R)
    words[idx[write].to(torch.int64)] = new[write]
    return ok


def cas_lock(words, idx, expected):
    """The Pallas ``cas_lock``'s FIFO, one request after another: request i
    wins iff 0 <= idx < R and the word equals ``expected``; the word then
    becomes ``expected | LOCK``.  Returns (ok, new_words); the input is
    left as it was."""
    w = words.detach().cpu().numpy().copy()
    ix = idx.detach().cpu().numpy()
    ex = expected.detach().cpu().numpy()
    ok = np.zeros(ix.shape[0], bool)
    lock = np.int32(LOCK_BIT)
    for i, (r, e) in enumerate(zip(ix, ex)):
        if 0 <= r < w.shape[0] and w[r] == e:
            w[r] = e | lock
            ok[i] = True
    return (torch.from_numpy(ok).to(words.device),
            torch.from_numpy(w).to(words.device))


def _agg_slots(slot, num_slots: int, check: bool) -> torch.Tensor:
    """int64 scatter indices: in-range slots as they are, every other row
    into one spare slot past the table (the kernel skips those rows).
    ``check=True`` raises on a slot outside [0, num_slots) instead."""
    ok = (slot >= 0) & (slot < num_slots)
    if check and not bool(ok.all()):
        raise ValueError(f"slot outside [0, {num_slots})")
    return torch.where(ok, slot, num_slots).to(torch.int64)


def grouped_agg(slot, vals, num_slots: int, *, check: bool = False):
    """Plain twin of ``grouped_agg.grouped_agg``: (num_slots,) f32 sums of
    ``vals`` by ``slot``, accumulated in f64 by ``index_add_`` and rounded
    once, so it is the exact sum within one f32 rounding wherever the
    kernel's order of f32 additions lands."""
    idx = _agg_slots(slot, num_slots, check)
    out = torch.zeros((num_slots + 1,), dtype=torch.float64,
                      device=slot.device)
    out.index_add_(0, idx, vals.to(torch.float64))
    return out[:num_slots].to(torch.float32)


def grouped_sum_u32(slot, vals, num_slots: int, *, check: bool = False):
    """Plain twin of ``grouped_agg.grouped_sum_u32``: (num_slots,) u32 sums
    mod 2**32 (int32 bit patterns) of the u32 words ``vals`` by ``slot``,
    summed exactly in int64 by ``index_add_`` and wrapped once."""
    idx = _agg_slots(slot, num_slots, check)
    out = torch.zeros((num_slots + 1,), dtype=torch.int64,
                      device=slot.device)
    out.index_add_(0, idx, u32(vals))
    return to_i32(out[:num_slots])
