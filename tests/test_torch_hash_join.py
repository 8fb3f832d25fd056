"""The local join and its aggregate as one call, ``ops.join_sum``.

On the CPU (``impl="plain"``, the sort-probe ``ref.join_sum``):

  * it equals a brute-force dict join and ``join_agg(*local_join(...))``
    on inputs shaped as the route leaves them: ``MISS`` slots (value 0)
    on both sides, products and sums that wrap at 2**32, keys >= 2**31, S
    keys absent from R, duplicate S keys, an empty R or S, |R| != |S|;
  * ``impl="kernel"`` on a CPU tensor raises, and a CPU join through the
    facade launches nothing;
  * the kernel's plan sizes its partitions and table from |R| alone.

On the card (marked ``gpu``; they skip here), the hand-written kernel
(``kernels/csrc/hash_join.cu``) equals the plain version exactly, as
integers, over a ragged sweep, a routed join at A = 2**24, an R whose keys
all fall in one hash partition (the chunked path), an S on one key and an
R with no ``MISS`` slot; each of the four join variants launches it once
a query; four ``MeshTransport`` shards agree with one; and a call waits
on nothing.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import shuffle
from repro_torch.db import JOIN_VARIANTS, Database
from repro_torch.fabric import LocalTransport, MeshTransport
from repro_torch.kernels import hash_join, ops, ref

MISS = -1
M32 = 0xFFFFFFFF


def _i32(a) -> torch.Tensor:
    """u32 values (any integer array) as int32 bit patterns."""
    return torch.from_numpy(
        (np.asarray(a, dtype=np.int64) & M32).astype(np.uint32).view(
            np.int32).copy())


def brute(rk, rv, sk, sv) -> int:
    """The u32 sum of matched u32 products, by a Python dict."""
    r = {int(k) & M32: int(v) & M32 for k, v in zip(rk.tolist(), rv.tolist())
         if k != MISS}
    return sum(r.get(int(k) & M32, 0) * (int(v) & M32)
               for k, v in zip(sk.tolist(), sv.tolist()) if k != MISS) % 2**32


def routed(keys, vals, empty: int, rng):
    """``keys``/``vals`` with ``empty`` MISS slots of value 0 among them,
    as a route leaves its empty slots."""
    k = np.concatenate([np.asarray(keys, np.int64), np.full(empty, M32)])
    v = np.concatenate([np.asarray(vals, np.int64), np.zeros(empty, np.int64)])
    order = rng.permutation(k.shape[0])
    return _i32(k[order]), _i32(v[order])


def draw(rng, *, nr=1000, ns=1500, r_empty=700, s_empty=300, lo=1,
         hi=5000, hit=0.6, vmax=2**32, s_distinct=None):
    """Unique R keys in [lo, hi) and S keys that hit R with ``hit``, each
    side with its empty slots; values uniform in [0, vmax)."""
    rk = rng.choice(np.arange(lo, hi, dtype=np.int64), nr, replace=False)
    pool = rk if s_distinct is None else rk[:s_distinct]
    if pool.shape[0] == 0:
        sk = rng.integers(lo, hi, ns)
    else:
        sk = np.where(rng.random(ns) < hit, rng.choice(pool, ns),
                      rng.integers(lo, hi, ns))
    rv = rng.integers(0, vmax, nr)
    sv = rng.integers(0, vmax, ns)
    return (*routed(rk, rv, r_empty, rng), *routed(sk, sv, s_empty, rng))


HIGH = 2**32 - 5000                     # keys >= 2**31, below MISS
CASES = {
    "miss_both_sides": {},
    "wrapping_sums": {"vmax": 2**32, "ns": 4000},
    "keys_above_2_31": {"lo": HIGH, "hi": M32},
    "keys_across_2_31": {"lo": 2**31 - 2500, "hi": 2**31 + 2500},
    "s_absent_from_r": {"hit": 0.0, "lo": 1, "hi": 100_000},
    "duplicate_s_keys": {"s_distinct": 3, "hit": 0.9},
    "empty_r": {"nr": 0, "r_empty": 0},
    "empty_r_slots_only": {"nr": 0, "r_empty": 64},
    "empty_s": {"ns": 0, "s_empty": 0},
    "r_smaller_than_s": {"nr": 37, "r_empty": 5, "ns": 6000},
    "r_larger_than_s": {"nr": 4000, "hi": 9000, "ns": 50, "s_empty": 3},
    "r_without_miss": {"r_empty": 0},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_join_sum_equals_dict_and_local_join(case):
    rng = np.random.default_rng(sorted(CASES).index(case))
    rk, rv, sk, sv = draw(rng, **CASES[case])
    got = ops.join_sum(rk, rv, sk, sv, impl="plain")
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) & M32 == brute(rk, rv, sk, sv)
    if rk.shape[0]:            # the sort-probe needs a row to search
        want = shuffle.join_agg(*shuffle.local_join(rk, rv, sk, sv), sv)
        assert torch.equal(got, want)


def test_wrapping_case_wraps():
    """The sums of the wrapping case do exceed 2**32 before they wrap."""
    rng = np.random.default_rng(sorted(CASES).index("wrapping_sums"))
    rk, rv, sk, sv = draw(rng, **CASES["wrapping_sums"])
    r = dict(zip((rk.numpy().astype(np.int64) & M32).tolist(),
                 (rv.numpy().astype(np.int64) & M32).tolist()))
    prods = [r.get(k, 0) * v for k, v in zip(
        (sk.numpy().astype(np.int64) & M32).tolist(),
        (sv.numpy().astype(np.int64) & M32).tolist()) if k != M32]
    assert max(prods) >= 2**32 and sum(prods) >= 2**40


def test_kernel_impl_on_cpu_raises():
    d = torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="kernel"):
        ops.join_sum(d, d, d, d, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        hash_join.join_sum(d, d, d, d)
    with pytest.raises(TypeError):
        ops.join_sum(d.long(), d, d, d)


@pytest.mark.parametrize("variant", JOIN_VARIANTS)
def test_cpu_join_launches_nothing(variant):
    rng = np.random.default_rng(3)
    n = 1 << 10
    rk = rng.permutation(np.arange(1, n + 1))
    db = Database(device="cpu")
    db.load_table("R", _i32(rk), _i32(rk))
    db.load_table("S", _i32(rng.integers(1, 2 * n, n)),
                  _i32(np.ones(n, np.int64)))
    before = ops.launch_counts()
    assert "hash_join" in before
    db.execute(db.scan("R").join(db.scan("S").filter(sel=0.5)).aggregate(),
               force_variant=variant)
    assert ops.launch_counts() == before


def test_plan_sizes_from_r_slots():
    # the benchmark's routed R: 2 x 128M slots, half of them empty
    p = hash_join.plan(256_000_000)
    assert (p.parts, p.lo_bits, p.table) == (1 << 15, 8, 1 << 14)
    assert 256_000_000 / p.parts <= p.table / 2
    assert hash_join.plan(2**25).bits == 12
    one = hash_join.plan(2**20 + 3)
    assert one.lo_bits == 0 and one.parts == 256
    small = hash_join.plan(1000)
    assert small.parts == 2 and small.table == 1024
    for rows in (1, 31, 1000, 2**20 + 3, 2**25, 256_000_000, 2**31 - 2**14):
        p = hash_join.plan(rows)
        assert 1 <= p.bits <= hash_join.MAX_BITS
        assert p.lo_bits == 0 or p.bits - p.lo_bits <= 7
        assert hash_join.MIN_TABLE <= p.table <= hash_join.TABLE_MAX
        assert p.table & (p.table - 1) == 0
        # the average partition fills at most half a table, unless the
        # partition count is at its cap
        assert rows / p.parts <= p.table / 2 or p.bits == hash_join.MAX_BITS


def one_partition_keys(n: int, bits: int, rng) -> np.ndarray:
    """n distinct u32 keys, none MISS, whose hash partition at ``bits`` is
    0: hashes with their top ``bits`` bits clear, mapped back through the
    inverse of the odd multiplier."""
    inv = pow(hash_join.HASH_MUL, -1, 2**32)
    h = np.unique(rng.integers(1, 2**(32 - bits), 2 * n))[:n]
    keys = (h.astype(object) * inv % 2**32).astype(np.int64)
    assert keys.shape[0] == n and M32 not in keys
    return keys


def test_one_partition_keys_fall_in_one_partition():
    rng = np.random.default_rng(5)
    bits = hash_join.plan(1 << 16).bits
    keys = one_partition_keys(1 << 12, bits, rng)
    h = keys.astype(np.uint64) * np.uint64(hash_join.HASH_MUL) % 2**32
    assert not (h >> np.uint64(32 - bits)).any()     # partition 0


# ---------------------------------------------------------- on the card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _both(rk, rv, sk, sv, dev):
    args = [t.to(dev) for t in (rk, rv, sk, sv)]
    return (ops.join_sum(*args, impl="kernel"),
            ops.join_sum(*args, impl="plain"))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_equals_plain_cases(card, case):
    rng = np.random.default_rng(sorted(CASES).index(case))
    rk, rv, sk, sv = draw(rng, **CASES[case])
    got, want = _both(rk, rv, sk, sv, card)
    assert torch.equal(got, want)
    assert int(got) & M32 == brute(rk, rv, sk, sv)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 31, 1000, 2**20 + 3])
def test_kernel_equals_plain_sweep(card, n):
    g = torch.Generator(device=card).manual_seed(n)
    rk = torch.randperm(2 * n + 1, generator=g, device=card)[:n] + 1
    rk = torch.where(torch.rand(n, generator=g, device=card) < 0.4, MISS,
                     rk).to(torch.int32)              # empty slots
    rv = torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device=card,
                       dtype=torch.int32)
    rv = torch.where(rk == MISS, 0, rv)
    m = n + n // 3
    sk = torch.randint(0, 2 * n + 3, (m,), generator=g, device=card,
                       dtype=torch.int32)
    sk = torch.where(torch.rand(m, generator=g, device=card) < 0.3, MISS, sk)
    sv = torch.randint(-2**31, 2**31 - 1, (m,), generator=g, device=card,
                       dtype=torch.int32)
    got, want = _both(rk, rv, sk, sv, card)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_routed_join_at_2_24(card):
    """R and S of A = 2**24 rows (the benchmark's draw at sel 0.5), each
    routed as RRJ routes them (one shard, cap 2A, 4 chunks): 2A slots a
    relation, half of them empty; two radix passes."""
    A = 1 << 24
    g = torch.Generator(device=card).manual_seed(24)
    rk = (torch.randperm(A, generator=g, device=card) + 1).to(torch.int32)
    sk = torch.where(torch.rand(A, generator=g, device=card) < 0.5,
                     torch.randint(1, A + 1, (A,), generator=g, device=card,
                                   dtype=torch.int32),
                     torch.randint(A + 1, 2 * A, (A,), generator=g,
                                   device=card, dtype=torch.int32))
    sv = torch.randint(-2**31, 2**31 - 1, (A,), generator=g, device=card,
                       dtype=torch.int32)
    tr = LocalTransport(device=card)
    rk2, rv2, _ = shuffle._route_by_key(tr, rk, rk, 2 * A, chunks=4)
    sk2, sv2, _ = shuffle._route_by_key(tr, sk, sv, 2 * A, chunks=4)
    assert hash_join.plan(rk2.shape[0]).lo_bits > 0
    got, want = _both(rk2, rv2, sk2, sv2, card)
    assert torch.equal(got, want)
    assert torch.equal(got, ops.join_sum(rk, rk, sk, sv, impl="plain"))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1 << 16, (1 << 18) + 7])
def test_kernel_one_partition_takes_the_chunked_path(card, n):
    """Every R key in hash partition 0: the partition holds several
    tables' worth of rows, built and probed chunk by chunk."""
    rng = np.random.default_rng(n)
    p = hash_join.plan(n)
    rk = one_partition_keys(n, p.bits, rng)
    assert n > p.table // 2
    sk = np.where(rng.random(2 * n) < 0.7, rng.choice(rk, 2 * n),
                  rng.integers(0, 2**32, 2 * n))
    sk = np.where(sk == M32, 0, sk)
    args = (_i32(rk), _i32(rng.integers(0, 2**32, n)), _i32(sk),
            _i32(rng.integers(0, 2**32, 2 * n)))
    got, want = _both(*args, card)
    assert torch.equal(got, want)
    assert int(got) & M32 == brute(*args)


@pytest.mark.gpu
def test_kernel_all_s_rows_on_one_key(card):
    rng = np.random.default_rng(8)
    n = 1 << 20
    rk = rng.permutation(np.arange(1, n + 1))
    rv = rng.integers(0, 2**32, n)
    sk = np.full(n, rk[12345])
    sv = rng.integers(0, 2**32, n)
    got, want = _both(_i32(rk), _i32(rv), _i32(sk), _i32(sv), card)
    assert torch.equal(got, want)
    assert int(got) & M32 == int(rv[12345]) * int(sv.sum()) % 2**32


def _relations(n: int, dev, seed: int = 0):
    g = torch.Generator(device=dev).manual_seed(seed)
    rk = (torch.randperm(n, generator=g, device=dev) + 1).to(torch.int32)
    sk = torch.randint(1, 2 * n, (n,), generator=g, device=dev,
                       dtype=torch.int32)
    sv = torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device=dev,
                       dtype=torch.int32)
    return rk, rk, sk, sv


def _query(db):
    return db.scan("R").join(db.scan("S").filter(sel=0.5)).aggregate()


@pytest.mark.gpu
@pytest.mark.parametrize("variant", JOIN_VARIANTS)
def test_each_variant_launches_the_kernel_once(card, variant):
    rk, rv, sk, sv = _relations(1 << 20, card)
    db = Database(device=card)
    db.load_table("R", rk, rv)
    db.load_table("S", sk, sv)
    before = ops.launch_counts()
    res = db.execute(_query(db), force_variant=variant)
    after = ops.launch_counts()
    assert after["hash_join"] - before["hash_join"] == 1
    assert torch.equal(res.value.cpu(),
                       ref.join_sum(rk.cpu(), rv.cpu(), sk.cpu(), sv.cpu()))


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["rrj", "ghj"])
def test_four_shards_agree_with_one(card, variant):
    rk, rv, sk, sv = _relations(1 << 20, card, seed=1)
    values = {}
    for shards in (4, 1):
        t = MeshTransport(4, device=card) if shards == 4 else \
            LocalTransport(device=card)
        db = Database(t)
        db.load_table("R", rk, rv)
        db.load_table("S", sk, sv)
        before = ops.launch_counts()["hash_join"]
        values[shards] = db.execute(_query(db), force_variant=variant).value
        assert ops.launch_counts()["hash_join"] - before == shards
    assert torch.equal(values[4].cpu(), values[1].cpu())


@pytest.mark.gpu
def test_a_call_waits_on_nothing(card, monkeypatch):
    """No ``torch.cuda.synchronize`` and, under the profiler, no
    synchronize or blocking copy of the CUDA runtime inside a call."""
    from torch.profiler import ProfilerActivity, profile
    args = _relations(1 << 20, card, seed=2)
    ops.join_sum(*args)                       # built and loaded
    torch.cuda.synchronize()
    calls = []
    sync = torch.cuda.synchronize
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "synchronize",
                  lambda *a, **k: calls.append(a) or sync(*a, **k))
        ops.join_sum(*args)
    assert not calls
    # the profiler syncs as it stops: only the call's own events count
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = ops.join_sum(*args)
    events = prof.events()
    names = {e.name for e in events}
    call = [e.time_range for e in events if e.name == "kernel.join"]
    assert len(call) == 1
    inside = {e.name for e in events
              if call[0].start <= e.time_range.start
              and e.time_range.end <= call[0].end}
    assert not {n for n in inside if "Synchronize" in n or n in (
        "cudaMemcpy", "aten::item", "aten::_local_scalar_dense")}, inside
    assert all(any(k in n for n in names) for k in ("join_hist",
                                                     "join_probe"))
    assert torch.equal(out, ops.join_sum(*args, impl="plain"))
