"""The grouped_agg kernel's keys entry and its planner, on the CPU.

* The keys entry (``ops.grouped_sum_u32_by_key``, here its plain
  version) against the JAX operators it replaces: ``segment_sum_by_key``,
  ``preagg_table`` and RDMA-AGG's phase-1 table, on u32 keys drawn with
  numpy, keys at and above 2**31 (negative as int32, where an int32 ``%``
  would be wrong) and sums that wrap.
* The kernel's arithmetic, emulated in numpy: the magic-number division
  (``grouped_agg.fast_divisor``) and the slot it gives a key, against
  Python's ``//`` and the plain slot.
* The planner: every slot in exactly one bucket, no table above the
  shared memory the plan claims, a hot bucket split over work items, the
  work items within the kernel's grid, and the partition path's data flow
  (buckets, then items) summing to the plain result.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro_torch._bits import np_to_i32, np_u32
from repro_torch.kernels import grouped_agg as ga, ops, ref

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

H100 = ga.H100


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np_to_i32(a))


def _inputs(n=6000, seed=0):
    """u32 keys over the whole range (a quarter at or above 2**31) and
    u32 values large enough that the sums wrap."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    keys[: n // 8] |= np.uint32(1 << 31)
    vals = rng.integers(2 ** 31, 2 ** 32, n, dtype=np.uint64).astype(
        np.uint32)
    return keys, vals


@pytest.mark.parametrize("groups", [1, 3, 64, 1000, 4096, 2 ** 31 - 1])
@pytest.mark.parametrize("fn", ["segment_sum_by_key", "preagg_table"])
def test_keys_entry_matches_jax_tables(fn, groups):
    keys, vals = _inputs()
    tab = min(groups, 1 << 16)      # the table the JAX function allocates
    want = np.asarray(getattr(jagg, fn)(jnp.asarray(keys), jnp.asarray(vals),
                                        tab))
    got = ops.grouped_sum_u32_by_key(_t(keys), _t(vals), tab)
    assert got.dtype == torch.int32 and got.shape == (tab,)
    np.testing.assert_array_equal(np_u32(got), want)
    assert (keys >= 2 ** 31).any()
    exact = np.bincount(keys % tab, weights=vals.astype(np.float64),
                        minlength=tab)
    assert exact.max() >= 2 ** 32          # the sums wrap


def _jax_phase1(keys, vals, groups, chunks, n):
    """RDMA-AGG's phase-1 table, as src/repro/core/aggregation.py builds
    it inside rdma_agg's body."""
    gsz = max(groups // n, 1)
    N = keys.shape[0]
    ck = jnp.asarray(keys).reshape(chunks, N // chunks)
    cv = jnp.asarray(vals).reshape(chunks, N // chunks)
    slot = (ck % jnp.uint32(groups)).astype(jnp.int32)
    owner = jnp.minimum(slot // gsz, n - 1)
    ci = jnp.broadcast_to(
        jnp.arange(chunks, dtype=jnp.int32)[:, None], slot.shape)
    part = jnp.zeros((chunks, n, gsz), jnp.uint64).at[
        ci, owner, slot % gsz].add(cv.astype(jnp.uint64))
    return np.asarray(part).reshape(-1)


@pytest.mark.parametrize("groups,chunks,n", [
    (64, 4, 1), (64, 4, 4), (3, 4, 4), (1, 4, 2), (4096, 2, 8),
    (1000, 4, 3), (7, 1, 4)])
def test_keys_entry_matches_rdma_phase1(groups, chunks, n):
    keys, vals = _inputs(n=4800, seed=groups)
    want = _jax_phase1(keys, vals, groups, chunks, n)
    got = ops.grouped_sum_u32_by_key(_t(keys), _t(vals), groups,
                                     chunks=chunks, n=n)
    assert got.shape == (ga.key_slots(groups, chunks, n),)
    np.testing.assert_array_equal(np_u32(got), want)


def test_keys_entry_refusals_and_no_launch():
    k = torch.zeros(10, dtype=torch.int32)
    before = ops.launch_counts()
    ops.grouped_sum_u32_by_key(k, k, 4, chunks=2, n=2)
    assert ops.launch_counts() == before
    with pytest.raises(ValueError, match="chunks"):
        ops.grouped_sum_u32_by_key(k, k, 4, chunks=3)
    with pytest.raises(TypeError, match="int32"):
        ops.grouped_sum_u32_by_key(k.to(torch.int64), k, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ga.grouped_sum_u32_by_key(k, k, 4)
    with pytest.raises(ValueError, match="kernel"):
        ops.grouped_sum_u32_by_key(k, k, 4, impl="kernel")


def _udiv(x: np.ndarray, div) -> np.ndarray:
    """The kernel's udiv in numpy (u64 arithmetic on u32 values)."""
    d, m, sh = div
    x = x.astype(np.uint64)
    if d == 1:
        return x
    t = (np.uint64(m) * x) >> np.uint64(32)
    return (t + ((x - t) >> np.uint64(1))) >> np.uint64(sh)


_EDGES = np.array([0, 1, 2, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1],
                  np.uint64)


@settings(max_examples=200, deadline=None)
@given(d=st.one_of(st.integers(1, 2 ** 31 - 1),
                   st.sampled_from([1, 2, 3, 7, 2048, 2 ** 26, 2 ** 26 + 1,
                                    2 ** 30 + 1, 2 ** 31 - 1])),
       seed=st.integers(0, 2 ** 16))
def test_fast_divisor_divides_every_u32(d, seed):
    x = np.concatenate([_EDGES, np.random.default_rng(seed).integers(
        0, 2 ** 32, 512, dtype=np.uint64)])
    div = ga.fast_divisor(d)
    assert 0 <= div[1] < 2 ** 32
    np.testing.assert_array_equal(_udiv(x, div), x // np.uint64(d))


def _kernel_slot(keys: np.ndarray, groups, chunks, n) -> np.ndarray:
    """SlotKey's arithmetic: u32 only, the chunk from its boundaries."""
    g, z = ga.fast_divisor(groups), ga.fast_divisor(max(groups // n, 1))
    k = keys.astype(np.uint64)
    s = k - _udiv(k, g) * np.uint64(g[0])
    if chunks == 1 and n == 1:
        return s
    q = _udiv(s, z)
    lo = s - q * np.uint64(z[0])
    owner = np.minimum(q, np.uint64(n - 1))
    clen = keys.shape[0] // chunks
    rows = np.arange(keys.shape[0])
    c = sum((rows >= (j + 1) * clen).astype(np.uint64)
            for j in range(chunks - 1)) if chunks > 1 else 0
    return (c * np.uint64(n) + owner) * np.uint64(z[0]) + lo


@settings(max_examples=60, deadline=None)
@given(groups=st.integers(1, 2 ** 31 - 1), chunks=st.integers(1, 6),
       n=st.integers(1, 9), seed=st.integers(0, 2 ** 16))
def test_kernel_key_slot_matches_plain(groups, chunks, n, seed):
    keys, _ = _inputs(n=chunks * 40, seed=seed)
    want, S = ref.key_slot(_t(keys), groups, chunks=chunks, n=n)
    got = _kernel_slot(keys, groups, chunks, n)
    np.testing.assert_array_equal(got, want.numpy())
    assert S == ga.key_slots(groups, chunks, n)
    assert int(want.max()) < S


@settings(max_examples=150, deadline=None)
@given(S=st.one_of(st.integers(1, ga.PARTITION_MAX_SLOTS + 8),
                   st.sampled_from(ga.boundaries(128_000_000))),
       rows=st.integers(0, 2 ** 31 + 4))
def test_plan_buckets_cover_every_slot_once_within_shared_memory(S, rows):
    p = ga.plan(S, rows)
    limit = H100[1] - 1024
    assert 1 <= p.grid <= 2 * H100[0] and p.smem <= limit
    if p.path == "shared":
        assert 1 <= p.copies <= ga.MAX_COPIES
        assert p.smem == p.copies * 4 * S
        return
    if p.path == "global":
        assert S > ga.PARTITION_MAX_SLOTS or rows >= 2 ** 31
        return
    assert p.buckets == -(-S // (1 << p.bits)) <= 16384
    ranges = [p.bucket_range(b, S) for b in range(p.buckets)]
    assert ranges[0][0] == 0 and ranges[-1][1] == S
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(lo < hi for lo, hi in ranges)
    # each bucket's table and the histogram of the buckets fit
    assert max(4 * (hi - lo) for lo, hi in ranges) <= p.smem
    assert 4 * p.buckets <= p.smem
    # each radix pass has at most 128 digits: the super-buckets, and the
    # buckets of a super-bucket
    assert p.supers <= 128 and (1 << p.lo_bits) <= 128
    assert (p.lo_bits == 0) == (p.buckets <= 128)
    assert p.supers << p.lo_bits >= p.buckets


def test_plan_boundaries_change_the_plan():
    bs = ga.boundaries(128_000_000)
    assert ga.SHARED_MAX_BYTES // 4 in bs and ga.PARTITION_MAX_SLOTS in bs
    for S in bs:
        a, b = ga.plan(S, 128_000_000), ga.plan(S + 1, 128_000_000)
        assert (a.path, a.bits, a.lo_bits, a.grid) != \
            (b.path, b.bits, b.lo_bits, b.grid)
    assert ga.plan(2048, 128_000_000).path == "shared"
    assert ga.plan(1 << 26, 128_000_000).path == "partition"
    assert ga.plan(1 << 28, 128_000_000).path == "partition"


@settings(max_examples=120, deadline=None)
@given(counts=st.lists(st.integers(0, 3000), min_size=1, max_size=40),
       hot=st.integers(0, 39), extra=st.integers(0, 20_000),
       rpp=st.integers(1, 4096))
def test_work_items_split_hot_buckets_within_the_grid(counts, hot, extra,
                                                      rpp):
    counts = np.array(counts)
    counts[hot % counts.shape[0]] += extra
    bucket, lo, hi, split = ga.work_items(counts, rpp)
    N = int(counts.sum())
    # the kernel launches nb + N // rpp blocks of part_agg
    assert bucket.shape[0] <= counts.shape[0] + N // rpp
    covered = np.zeros(N, np.int64)
    for b, a, e in zip(bucket, lo, hi):
        covered[a:e] += 1
        assert e - a <= rpp
    assert (covered == 1).all()
    for b in range(counts.shape[0]):
        items = (bucket == b).sum()
        assert items >= 1
        assert (items > 1) == (counts[b] > rpp) == split[bucket == b].any()


@pytest.mark.parametrize("S,rpp", [(3000, 500), (70_000, 2000),
                                   (1 << 20, 700), ((1 << 23) + 5, 900)])
def test_partition_data_flow_sums_like_plain(S, rpp):
    """Emulate part_hist, part_scan, part_scatter (and part_refine) and
    part_agg in numpy from the plan, with one hot slot, and hold the table
    to the plain version's."""
    rng = np.random.default_rng(S)
    N = 20_000
    slot = rng.integers(-5, S + 5, N)
    slot[rng.random(N) < 0.5] = S // 3                 # a hot slot
    vals = rng.integers(0, 2 ** 32, N, dtype=np.uint64)
    p = ga.plan(S, N, path="partition")
    assert (p.batch < N) == (p.lo_bits > 0)
    # each batch counted apart; its pairs land after the batches before it
    # in every bucket's run: the layout of all rows sorted by bucket
    batch = np.arange(N) // p.batch
    ok = (slot >= 0) & (slot < S)
    bkt = slot[ok] >> p.bits
    per_batch = [np.bincount(bkt[batch[ok] == k], minlength=p.buckets)
                 for k in range(batch.max() + 1)]
    counts = sum(per_batch)
    order = np.lexsort((batch[ok], bkt))
    low = (slot[ok] & ((1 << p.bits) - 1))[order]
    v = vals[ok][order]
    out = np.zeros(S, np.uint64)
    bucket, lo, hi, split = ga.work_items(counts, rpp)
    assert split.any()
    for b, a, e in zip(bucket, lo, hi):
        base, end = p.bucket_range(b, S)
        tab = np.zeros(end - base, np.uint64)
        np.add.at(tab, low[a:e], v[a:e])
        out[base:end] += tab
    want = ref.grouped_sum_u32(torch.from_numpy(slot.astype(np.int32)),
                               _t(vals.astype(np.uint32)), S)
    np.testing.assert_array_equal(out & np.uint64(0xFFFFFFFF), np_u32(want))


@settings(max_examples=100, deadline=None)
@given(S=st.integers(ga.SHARED_MAX_BYTES // 4 + 1, ga.PARTITION_MAX_SLOTS),
       rows=st.integers(1, 2 ** 31 - 1))
def test_partition_scratch_within_12_bytes_a_row(S, rows):
    """At most two batches; the pairs of all rows and one batch's pairs of
    the first pass stay within 12 B a row (the int64 slot arrays the keys
    entry replaces took 16), plus one tile."""
    p = ga.plan(S, rows)
    batches = -(-rows // p.batch)
    assert 1 <= batches <= 2 and (batches == 2) <= (p.lo_bits > 0)
    assert p.batch % 4 == 0 or p.batch == rows
    first = 8 * min(p.batch, rows) if p.lo_bits else 0
    assert 8 * rows + first <= 12 * rows + 8 * ga.TILE
