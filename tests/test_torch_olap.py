"""The OLAP operators of the port against the JAX package, bit for bit.

Inputs are drawn once with numpy from a seed and fed to both packages (as
u32 arrays to JAX, as int32 bit patterns to the port); JAX runs eagerly
under its ``LocalTransport``, so its counters count every call as the
port's do.  Covered: the bloom filter's bits, the local joins, the four
distributed joins (value, dropped rows, ``transport.stats()``), Dist-AGG
and RDMA-AGG (u32 sums that wrap at 2**32), and both plain versions of the
grouped-aggregation kernel (the f32 one against the Pallas kernel in
interpret mode at atol 1e-3, rtol 1e-4; the u32 one against the jnp
scatter-add).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import bloom as jbloom
from repro.core import shuffle as jshuffle
from repro.fabric import LocalTransport as JaxLocalTransport
from repro.kernels import ops as jops
from repro_torch._bits import np_to_i32, np_u32
from repro_torch.core import aggregation, bloom, shuffle
from repro_torch.fabric import LocalTransport
from repro_torch.kernels import ops, ref

VARIANTS = ("ghj", "ghj_bloom", "rdma_ghj", "rrj")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np_to_i32(a))


@pytest.fixture(scope="module")
def rel():
    """R of 2048 unique keys (rv = 3 rk), S of 4096 keys half of which
    hit R (sv = 2), as in tests/test_core_olap.py, from numpy."""
    rng = np.random.default_rng(0)
    rk = rng.permutation(np.arange(1, 2049, dtype=np.uint32))
    sk = rng.integers(1, 4096, 4096).astype(np.uint32)
    return rk, rk * np.uint32(3), sk, np.full(4096, 2, np.uint32)


@pytest.mark.parametrize("m_bits", [1 << 10, 1 << 14, 1 << 20])
def test_bloom_bits_match_jax(rel, m_bits):
    rk, _, sk, _ = rel
    want = np.asarray(jbloom.build(jnp.asarray(rk), m_bits))
    got = bloom.build(_t(rk), m_bits)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        bloom.query(got, _t(sk)).numpy(),
        np.asarray(jbloom.query(jnp.asarray(want), jnp.asarray(sk))))


def test_bloom_hash_wraps_full_u32_keys():
    """Keys with the top bit set (negative int32 bit patterns) hash as
    u32: the shifts are logical and every product wraps."""
    keys = np.random.default_rng(1).integers(0, 2 ** 32, 5000,
                                             dtype=np.uint64).astype(np.uint32)
    keys[:3] = (0, 0xFFFFFFFF, 0x80000000)
    for seed in range(3):
        np.testing.assert_array_equal(
            bloom._hash(_t(keys), seed, 12345).numpy(),
            np.asarray(jbloom._hash(jnp.asarray(keys), seed, 12345)))


@pytest.mark.parametrize("bits_from", [0, 16])
def test_radix_partition_matches_jax(bits_from):
    keys = np.random.default_rng(2).integers(0, 2 ** 32, 3000,
                                             dtype=np.uint64).astype(np.uint32)
    jp, jo, jc = jshuffle.radix_partition(jnp.asarray(keys), 32,
                                          bits_from=bits_from)
    p, o, c = shuffle.radix_partition(_t(keys), 32, bits_from=bits_from)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


@pytest.mark.parametrize("local", ["ghj", "ghj_bloom", "rrj"])
def test_local_joins_match_jax(rel, local):
    args_j = [jnp.asarray(a) for a in rel]
    args_t = [_t(a) for a in rel]
    if local == "rrj":
        want, got = jshuffle.rrj_local(*args_j), shuffle.rrj_local(*args_t)
    else:
        ub = local == "ghj_bloom"
        want = jshuffle.ghj_local(*args_j, use_bloom=ub)
        got = shuffle.ghj_local(*args_t, use_bloom=ub)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(np_u32(got)) == int(want)


def test_join_agg_wraps_at_2_32():
    """u32 products summed in u32: wraps exactly as the JAX sum does."""
    rng = np.random.default_rng(3)
    rv = rng.integers(0, 2 ** 32, 512, dtype=np.uint64).astype(np.uint32)
    sv = rng.integers(0, 2 ** 32, 512, dtype=np.uint64).astype(np.uint32)
    hit = rng.random(512) < 0.7
    want = jshuffle.join_agg(jnp.asarray(hit), jnp.asarray(rv),
                             jnp.asarray(sv))
    got = shuffle.join_agg(torch.from_numpy(hit), _t(rv), _t(sv))
    assert int(np_u32(got)) == int(want)
    exact = int(np.sum(np.where(hit, rv.astype(object) * sv, 0)))
    assert exact > 2 ** 32 and int(want) == exact % 2 ** 32


@pytest.mark.parametrize("capacity_factor", [2.0, 0.4])
@pytest.mark.parametrize("variant", VARIANTS)
def test_distributed_join_matches_jax(rel, variant, capacity_factor):
    jt, tt = JaxLocalTransport(), LocalTransport(device="cpu")
    want, jdrop = jshuffle.make_distributed_join(
        jt, variant, capacity_factor=capacity_factor, return_stats=True)(
            *[jnp.asarray(a) for a in rel])
    got, drop = shuffle.make_distributed_join(
        tt, variant, capacity_factor=capacity_factor, return_stats=True)(
            *[_t(a) for a in rel])
    assert int(np_u32(got)) == int(want)
    assert int(drop) == int(jdrop)
    assert (int(drop) > 0) == (capacity_factor < 1)
    assert tt.stats() == jt.stats()


def test_distributed_join_refuses_unknown_variant():
    with pytest.raises(ValueError, match="not in"):
        shuffle.make_distributed_join(LocalTransport(device="cpu"), "nlj")


def _agg_inputs(wrap: bool, n: int = 4096):
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    vals = (rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
            if wrap else np.ones(n, np.uint32))
    return keys, vals


@pytest.mark.parametrize("wrap", [False, True], ids=["ones", "wrapping"])
@pytest.mark.parametrize("groups", [1, 4, 64, 512])
@pytest.mark.parametrize("scheme", ["dist_agg", "rdma_agg"])
def test_aggregation_matches_jax(scheme, groups, wrap):
    keys, vals = _agg_inputs(wrap)
    jt, tt = JaxLocalTransport(), LocalTransport(device="cpu")
    want = np.asarray(getattr(jagg, scheme)(jt, groups)(
        jnp.asarray(keys), jnp.asarray(vals)))
    got = getattr(aggregation, scheme)(tt, groups)(_t(keys), _t(vals))
    assert got.dtype == torch.int32 and got.shape == (groups,)
    np.testing.assert_array_equal(np_u32(got), want)
    assert tt.stats() == jt.stats()
    exact = np.bincount(keys % groups, weights=vals.astype(np.float64),
                        minlength=groups)
    assert (exact.max() >= 2 ** 32) == wrap


@pytest.mark.parametrize("fn", ["segment_sum_by_key", "preagg_table"])
def test_preaggregation_tables_match_jax(fn):
    keys, vals = _agg_inputs(True)
    want = np.asarray(getattr(jagg, fn)(jnp.asarray(keys),
                                        jnp.asarray(vals), 4096))
    got = getattr(aggregation, fn)(_t(keys), _t(vals), 4096)
    np.testing.assert_array_equal(np_u32(got), want)


@pytest.mark.parametrize("n,slots", [(1024, 64), (2048, 128), (512, 16)])
def test_grouped_agg_plain_matches_pallas(n, slots):
    """The f32 plain version (and the CPU dispatch) against the Pallas
    kernel in interpret mode, as tests/test_kernels.py holds it."""
    rng = np.random.default_rng(n)
    slot = rng.integers(0, slots, n).astype(np.int32)
    vals = rng.standard_normal(n).astype(np.float32)
    want = np.asarray(jops.grouped_agg(jnp.asarray(slot), jnp.asarray(vals),
                                       slots, interpret=True))
    got = ops.grouped_agg(torch.from_numpy(slot), torch.from_numpy(vals),
                          slots)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("slots", [1, 64, 4096])
def test_grouped_sum_u32_plain_matches_jnp_scatter_add(slots):
    rng = np.random.default_rng(slots)
    slot = rng.integers(0, slots, 5000).astype(np.int32)
    vals = rng.integers(0, 2 ** 32, 5000, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jnp.zeros((slots,), jnp.uint32).at[
        jnp.asarray(slot)].add(jnp.asarray(vals)))
    got = ops.grouped_sum_u32(torch.from_numpy(slot), _t(vals), slots)
    np.testing.assert_array_equal(np_u32(got), want)


def test_grouped_plain_range_rule():
    """A slot outside [0, S) is skipped, as the kernel skips it, or raises
    when the caller asks for the check; u32 sums want int32 words."""
    slot = torch.tensor([-1, 0, 5, 1, 1], dtype=torch.int32)
    ones = torch.ones(5, dtype=torch.int32)
    assert ops.grouped_sum_u32(slot, ones, 2).tolist() == [1, 2]
    assert ops.grouped_agg(slot, ones.float(), 2).tolist() == [1.0, 2.0]
    with pytest.raises(ValueError, match="outside"):
        ref.grouped_sum_u32(slot, ones, 2, check=True)
    with pytest.raises(ValueError, match="outside"):
        ops.grouped_agg(slot, ones.float(), 2, check=True)
    with pytest.raises(TypeError, match="int32"):
        ops.grouped_sum_u32(slot, ones.to(torch.int64), 2)


def test_grouped_plain_launches_nothing():
    before = ops.launch_counts()
    assert {"grouped_agg", "grouped_sum_u32"} <= set(before)
    slot = torch.zeros(8, dtype=torch.int32)
    ops.grouped_agg(slot, torch.ones(8), 4)
    ops.grouped_sum_u32(slot, torch.ones(8, dtype=torch.int32), 4)
    assert ops.launch_counts() == before
