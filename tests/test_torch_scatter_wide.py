"""The wide scatter body's arithmetic, emulated on the CPU.

``scatter_wide`` (``src/repro_torch/kernels/csrc/radix_partition.cu``)
copies each kept row i with slot s to ``out[s*wo : s*wo + wo]`` (wo = w +
1, the valid lane last) as a streaming shifted copy: a block takes one
(row, span) item, a span being ``kSpan`` 16-byte chunks of the row's
destination; the row's head (the ints before its first 16-byte boundary)
and tail (the lanes after its last whole chunk, and the valid lane) are
written one int at a time by span 0's block; each middle chunk takes its 4
ints from the row's aligned source chunks q and q + 1, shifted by the
row's e = (source address + head) mod 4 ints.  A warp takes ``kUnroll``
runs of 32 chunks of a span, one after another; q + 1 comes from the next
lane, or for lane 31 from lane 0's chunk of the next run, and is loaded
by the lane itself only past the warp's last run or past the row's middle.
Tail blocks zero each bucket's slots past the rank's ``counts``.

:func:`emulate` repeats that arithmetic int by int on aligned 4-int words
of a flat store (the rows' view may start at any int of it), with a block
of 2 warps of 4 lanes and 2 runs (spans of 16 chunks, so rows cross many
spans), and records every write and every aligned load.  From the same numpy inputs it must give the port's plain
``ref.scatter`` and the JAX router's wire buffer (``plan_route`` +
``_scatter_rows``) bit for bit, write every int of the buffer exactly once,
and load no chunk that holds none of the row's own ints; a control with
the shift off by one must not.  The cases cover every w + 1 mod 4, row
bases at every int offset, masked rows, n > 1 with slots out of arrival
order, and empty buckets.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fabric import router as jr
from repro_torch.kernels import ref

# a block here: 2 warps of 4 lanes, 2 runs a warp (the kernel's: 8 warps of
# 32 lanes, kUnroll runs; a span of 1024 chunks)
WARPS, LANES, RUNS = 2, 4, 2
SPAN = WARPS * LANES * RUNS
WIDTHS = (2000, 2001, 2002, 5003)     # w + 1 = 1, 2, 3, 0 mod 4


def emulate(store, off, A, w, slot, num_slots, counts, mask=None,
            skew=0):
    """The kernel's buffer (num_slots, w + 1) for rows ``store[off : off +
    A w]`` viewed as (A, w) (``store`` 16-byte aligned at 0, a multiple of
    4 ints long), and how often each int was written.  ``skew`` adds to
    every row's shift (a faulty body)."""
    wo = w + 1
    n = counts.shape[0]
    cap = num_slots // n
    out = np.full(num_slots * wo, 0x5eed, np.int64)
    writes = np.zeros(num_slots * wo, np.int64)
    words = store.reshape(-1, 4)
    spans = max(-(-(w // 4) // SPAN), 1)

    def load(q, lo, hi):
        # an aligned 16-byte load must hold one of the row's ints [lo, hi)
        assert ((4 * q + 3 >= lo) & (4 * q < hi)).all(), "load outside row"
        return words[q]

    def put(p, v):
        np.add.at(writes, p, 1)
        out[p] = v

    for i in range(A):
        s = int(slot[i])
        if not 0 <= s < num_slots:
            continue
        m = mask is None or bool(mask[i])
        src = off + i * w                      # the row's first int
        d0 = s * wo
        hd = (-d0) % 4                         # ints before a boundary
        n4 = (w - hd) // 4 if w > hd else 0    # whole chunks of lanes
        for k in range(spans):
            if k == 0:                         # head and tail, int by int
                p = np.array([x for x in range(4) if x < hd and x < wo]
                             + [x for x in range(hd + 4 * n4, wo)],
                             np.int64)
                v = np.where(p < w, store[src + np.minimum(p, w - 1)], 1)
                put(d0 + p, v if m else 0)
            j0, j1 = k * SPAN, min(k * SPAN + SPAN, n4)
            if j0 >= j1:
                continue
            j = np.arange(j0, j1)
            dst = d0 + hd + 4 * j[:, None] + np.arange(4)
            if not m:
                put(dst, 0)
                continue
            sp = src + hd
            e = (sp + skew) % 4
            q = sp // 4 + j                    # each lane's aligned chunk
            x = load(q, src, src + w)
            v = x
            if e:
                r = j - j0
                lane, run = r % LANES, r // LANES % RUNS
                # q + 1 from the lane holding chunk j + 1 (the next lane,
                # or lane 0 of the next run), else the lane's own load
                y = np.roll(x, -1, axis=0)
                own = ((lane == LANES - 1) & (run == RUNS - 1)) | (j + 1 == j1)
                if own.any():
                    y[own] = load(q[own] + 1, src, src + w)
                v = np.concatenate([x, y], axis=1)[:, e:e + 4]
            put(dst, v)
    for d in range(n):                         # tail blocks
        lo = (d * cap + min(max(int(counts[d]), 0), cap)) * wo
        put(np.arange(lo, (d + 1) * cap * wo), 0)
    return out.astype(np.int32).reshape(num_slots, wo), writes


def _inputs(w, off, layout, seed):
    """(store, rows view, dest, n, cap, mask) from numpy: ``push`` 4 rows
    into one bucket (a PS push, RDMA-AGG's flush at n = 1); ``flush4`` 16
    rows to owners 0..3 four times over (RDMA-AGG's flush on 4 shards:
    slots out of arrival order); ``random`` 12 rows into 8 buckets with
    filtered dests, masked rows and caps above and below the counts."""
    rng = np.random.default_rng(seed)
    if layout == "push":
        dest, n, cap = np.zeros(4, np.int32), 1, 4
    elif layout == "flush4":
        dest, n, cap = np.tile(np.arange(4, dtype=np.int32), 4), 4, 4
    else:
        dest, n, cap = rng.integers(-1, 9, 12).astype(np.int32), 8, 2
    A = dest.shape[0]
    size = -(-(off + A * w) // 4) * 4
    store = rng.integers(-2 ** 31, 2 ** 31, size).astype(np.int32)
    rows = store[off:off + A * w].reshape(A, w)
    mask = rng.random(A) < 0.7 if layout == "random" else None
    return store, rows, dest, n, cap, mask


def _plain_and_jax(rows, dest, n, cap, mask):
    slot, _, _, counts = ref.rank(torch.from_numpy(dest), n, cap)
    want = ref.scatter(torch.from_numpy(rows.copy()), slot, n * cap,
                       counts=counts, mask=None if mask is None
                       else torch.from_numpy(mask)).numpy()
    plan = jr.plan_route(jnp.asarray(dest), n=n, cap=cap)
    # the JAX router's words are u32: the rows' bit patterns, valid lane 1
    packed = jnp.concatenate([jnp.asarray(rows.view(np.uint32)),
                              jnp.ones((rows.shape[0], 1), jr.WORD)], 1)
    wire = np.asarray(jr._scatter_rows(
        packed, plan, None if mask is None else jnp.asarray(mask)))
    assert wire.dtype == np.uint32
    wire = wire.view(np.int32)
    np.testing.assert_array_equal(np.asarray(plan.slot), slot.numpy())
    return slot.numpy(), counts.numpy(), want, wire


@pytest.mark.parametrize("layout", ["push", "flush4", "random"])
@pytest.mark.parametrize("off", [0, 1, 2, 3])
@pytest.mark.parametrize("w", WIDTHS)
def test_wide_body_is_the_wire_buffer(w, off, layout):
    store, rows, dest, n, cap, mask = _inputs(w, off, layout, w + off)
    slot, counts, want, wire = _plain_and_jax(rows, dest, n, cap, mask)
    got, writes = emulate(store, off, rows.shape[0], w, slot, n * cap,
                          counts, mask)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, wire)
    assert (writes == 1).all(), "an int written other than once"
    if layout == "random":
        assert (counts < cap).any() or (counts == 0).any()


@pytest.mark.parametrize("w", WIDTHS)
def test_shift_off_by_one_is_caught(w):
    store, rows, dest, n, cap, mask = _inputs(w, 1, "push", w)
    slot, counts, want, _ = _plain_and_jax(rows, dest, n, cap, mask)
    got, _ = emulate(store, 1, rows.shape[0], w, slot, n * cap, counts,
                     mask, skew=1)
    assert not np.array_equal(got, want)
