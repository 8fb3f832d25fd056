"""Plain PyTorch versions of the port's kernels.

Each function here computes exactly what its CUDA kernel computes, in
ordinary tensor operations, on any device.  The CPU runs them; on the card
``chip_smoke.py`` holds each kernel against them.  All 32-bit words are
int32 bit patterns (:mod:`repro_torch._bits`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._bits import LOCK_BIT, M32, mul32, put_rows, to_i32, u32

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
            counts: torch.Tensor, mask=None,
            fuse_valid: bool = True) -> torch.Tensor:
    """Plain twin of ``radix_partition.scatter``: rows into a zeroed
    (num_slots, w [+1]) int32 buffer at in-range, unmasked slots.  Like the
    kernel it takes :func:`rank`'s ``counts`` (n,) and refuses a
    ``num_slots`` that is not n times a cap; the result does not read
    them."""
    n = counts.shape[0] if counts.dim() == 1 else 0
    if n < 1 or int(num_slots) % n:
        raise ValueError(f"num_slots={num_slots} is not counts.numel()="
                         f"{counts.numel()} times a cap")
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
                  counts=counts, fuse_valid=fuse_valid)
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
    put_rows(words, idx, new, ok & (idx < R))
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


def key_slot(keys, groups: int, *, chunks: int = 1, n: int = 1):
    """int64 slot of each u32 key (int32 bit pattern) in the table of
    ``grouped_agg.grouped_sum_u32_by_key``: ``s = key % groups``, and
    unless ``chunks = n = 1`` RDMA-AGG's phase-1 layout ``(c * n +
    min(s // gsz, n - 1)) * gsz + s % gsz`` with ``gsz = max(groups // n,
    1)`` for a row of chunk c.  Returns (slot, number of slots)."""
    N = keys.shape[0]
    if chunks < 1 or n < 1 or N % chunks:
        raise ValueError(f"{N} rows do not split into {chunks} chunks, or "
                         f"n={n} < 1")
    s = u32(keys) % groups
    if chunks == 1 and n == 1:
        return s, groups
    gsz = max(groups // n, 1)
    owner = torch.clamp(s // gsz, max=n - 1)
    c = torch.arange(N, device=keys.device) // (N // chunks)
    return (c * n + owner) * gsz + s % gsz, chunks * n * gsz


def grouped_sum_u32_by_key(keys, vals, groups: int, *, chunks: int = 1,
                           n: int = 1):
    """Plain twin of ``grouped_agg.grouped_sum_u32_by_key``: the slots
    built in torch (:func:`key_slot`), then :func:`grouped_sum_u32`."""
    slot, S = key_slot(keys, groups, chunks=chunks, n=n)
    return grouped_sum_u32(slot, vals, S)


def join_sum(rk, rv, sk, sv):
    """Plain twin of ``hash_join.join_sum``, the sort-probe: R's keys
    sorted as u32 (a ``MISS`` key as 2**32, after every u32 key), each S
    key searched among them, and the u32 products of the matched values
    summed exactly in int64 and wrapped once.  A ``MISS`` key (0xFFFFFFFF)
    is no row on either side.  A 0-dim int32 bit pattern."""
    if rk.shape[0] == 0 or sk.shape[0] == 0:
        return torch.zeros((), dtype=torch.int32, device=rk.device)
    keys = torch.where(rk == -1, M32 + 1, u32(rk))
    rks, order = torch.sort(keys)
    sk64 = u32(sk)
    pos = torch.searchsorted(rks, sk64).clamp(max=rks.shape[0] - 1)
    hit = (rks[pos] == sk64) & (sk != -1)
    prod = mul32(u32(rv[order[pos]]), u32(sv))
    return to_i32(torch.where(hit, prod, 0).sum())


NEG_INF = -1e30
_ATTN_ROWS = 1024      # query rows a block of the plain attention
_SSD_CHUNK = 64        # steps a block of the plain SSD


def flash_attention(q, k, v, *, causal: bool = True):
    """Plain twin of ``flash_attention.flash_attention`` (the JAX
    ``ref.flash_attention``): full softmax in f32 over every key, scores
    scaled by q's width D^-0.5 and masked at -1e30, out in q's dtype.  q
    (B, S, H, D), k (B, T, KH, D), v (B, T, KH, Dv) -> (B, S, H, Dv); head
    h reads kv head h // (H // KH).  It takes 1024 query rows at a
    time, so the scores of a long prompt never fill memory at once; rows
    are independent, so that changes nothing."""
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    kk = k.to(torch.float32).repeat_interleave(G, dim=2)
    vv = v.to(torch.float32).repeat_interleave(G, dim=2)
    kpos = torch.arange(T, device=q.device)
    out = q.new_empty((B, S, H, v.shape[-1]))
    for s0 in range(0, S, _ATTN_ROWS):
        qc = q[:, s0:s0 + _ATTN_ROWS].to(torch.float32)
        sc = torch.einsum("bshd,bthd->bhst", qc, kk) * D ** -0.5
        if causal:
            qpos = torch.arange(s0, s0 + qc.shape[1], device=q.device)
            sc = torch.where(kpos[None, :] <= qpos[:, None], sc, NEG_INF)
        p = torch.softmax(sc, dim=-1)
        out[:, s0:s0 + _ATTN_ROWS] = torch.einsum(
            "bhst,bthd->bshd", p, vv).to(q.dtype)
    return out


def ssd_scan(xh, bv, cv, dt, a, state0=None):
    """Plain twin of ``ssd_scan.ssd_scan``: the SSD recurrence in its
    chunked form (``repro.models.ssm.ssd_chunked``'s arithmetic, in f32),
    over any S (the last chunk is padded with dt = 0, which leaves the
    state alone).  xh (B, S, H, hd), bv/cv (B, S, N), dt (B, S, H) f32,
    a (H,) f32, state0 (B, H, hd, N) f32 or None.  Returns (y in xh's
    dtype, final state f32).  It takes ``_SSD_CHUNK`` steps a block."""
    Bsz, S, H, P = xh.shape
    N = bv.shape[-1]
    L = _SSD_CHUNK
    pad = (-S) % L
    f32 = torch.float32

    def blocks(t, *tail):
        t = t.to(f32)
        if pad:
            t = torch.cat([t, t.new_zeros((Bsz, pad) + tuple(tail))], 1)
        return t.reshape((Bsz, (S + pad) // L, L) + tuple(tail))

    x, b, c, d = (blocks(xh, H, P), blocks(bv, N), blocks(cv, N),
                  blocks(dt, H))
    a = a.to(f32)
    state = (torch.zeros((Bsz, H, P, N), dtype=f32, device=xh.device)
             if state0 is None else state0.to(f32).clone())
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=xh.device))[None, :, :, None]
    ys = []
    for ci in range(x.shape[1]):
        xc, bc, cc, dc = x[:, ci], b[:, ci], c[:, ci], d[:, ci]
        seg = torch.cumsum(dc * a, dim=1)                    # (B, L, H)
        # inter-chunk: y_i += C_i . state * exp(seg_i)
        y_inter = (torch.einsum("bln,bhpn->blhp", cc, state)
                   * torch.exp(seg)[..., None])
        # intra-chunk: (C_i . B_j) exp(seg_i - seg_j) dt_j x_j, j <= i
        cb = torch.einsum("bin,bjn->bij", cc, bc)
        # masked before exp, so no overflow above the diagonal reaches a
        # gradient (0 * inf); the unmasked values are unchanged
        decay = torch.exp(torch.where(mask, seg[:, :, None, :]
                                      - seg[:, None, :, :], -torch.inf))
        m = torch.where(mask, decay * dc[:, None, :, :], 0.0)  # (B,i,j,H)
        y_intra = torch.einsum("bijh,bjhp->bihp", cb[..., None] * m, xc)
        # state update
        w = torch.exp(seg[:, -1:, :] - seg) * dc             # (B, L, H)
        state = (state * torch.exp(seg[:, -1])[:, :, None, None]
                 + torch.einsum("blhp,bln->bhpn", w[..., None] * xc, bc))
        ys.append(y_inter + y_intra)
    y = torch.stack(ys, 1).reshape(Bsz, S + pad, H, P)[:, :S]
    return y.to(xh.dtype), state
