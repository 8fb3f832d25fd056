"""The port's two-tier block store against the JAX package's, on the CPU.

The same op sequences (get, put, prefetch, drop, quiesce) go through
``repro.fabric.tier.TieredStore`` and ``repro_torch.fabric.tier.TieredStore``;
after every op the resident blocks (in hot-slot order), every counter and
the rows a ``get`` returns are equal, and at the end the cold and hot words
(as ``uint32``) and the transports' ``read_cold``, ``write_cold``,
``read_hot`` and ``write_hot`` counters are equal.  A hypothesis property
runs random sequences at every hot size 1..n.

Two regressions hold the places where a torch row is a view of the hot tier
and a JAX row is a value: a hit evicted by a miss in the same ``get``, and a
dirty write-back of a slot the same op refills, both at ``hot_blocks=1``.
The unsignaled write-back fixtures of ``tests/test_check.py`` run on both
packages' transports with ``tier="cold"`` and report the same violations.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fabric import LocalTransport as JLocal
from repro.fabric import NamPool as JPool
from repro.fabric import TieredStore as JStore
from repro.fabric import check as jcheck
from repro_torch.fabric import LocalTransport, NamPool, TieredStore, check

N_BLOCKS, WORDS = 6, 4
TIER_VERBS = ("read_cold", "write_cold", "read_hot", "write_hot")


class _Pair:
    """A JAX store and a port store fed the same ops."""

    def __init__(self, hot_blocks, n_blocks=N_BLOCKS, words=WORDS):
        self.jtp, self.ttp = JLocal(), LocalTransport(device="cpu")
        self.j = JStore(JPool(), self.jtp, "kv", n_blocks, words,
                        hot_blocks=hot_blocks)
        self.t = TieredStore(NamPool(), self.ttp, "kv", n_blocks, words,
                             hot_blocks=hot_blocks)

    def op(self, name, blocks=(), vals=None):
        if name == "put":
            self.j.put(blocks, jnp.asarray(vals), dirty=True)
            self.t.put(blocks, torch.from_numpy(vals.view(np.int32)),
                       dirty=True)
        elif name == "get":
            a = np.asarray(self.j.get(blocks))
            b = self.t.get(blocks).numpy().view(np.uint32)
            np.testing.assert_array_equal(b, a)
        elif name == "prefetch":
            assert self.t.prefetch(blocks) == self.j.prefetch(blocks)
        elif name == "drop":
            self.j.drop(blocks)
            self.t.drop(blocks)
        else:
            self.j.quiesce()
            self.t.quiesce()
        assert self.t.resident_blocks() == self.j.resident_blocks()
        assert self.t.counters == self.j.counters
        assert self.t.stats() == self.j.stats()

    def check_end(self):
        for tier in ("cold", "hot"):
            np.testing.assert_array_equal(
                getattr(self.t, tier).numpy().view(np.uint32),
                np.asarray(getattr(self.j, tier)), err_msg=tier)
        js, ts = self.jtp.stats(), self.ttp.stats()
        for verb in TIER_VERBS:
            assert ts.get(verb) == js.get(verb), verb


def _vals(rng, k):
    return rng.integers(0, 2 ** 32, (k, WORDS), dtype=np.uint32)


def _script_ops(rng):
    ops = []
    for op, blocks in [("put", [0, 1]), ("get", [2]), ("get", [0]),
                       ("put", [3]), ("get", [1]), ("get", [4]),
                       ("put", [2]), ("get", [0, 3]), ("prefetch", [1, 5]),
                       ("get", [5, 2, 5]), ("drop", [3, 1]), ("get", [1]),
                       ("quiesce", [])]:
        ops.append((op, blocks, _vals(rng, len(blocks))))
    return ops


@pytest.mark.parametrize("hot", range(1, N_BLOCKS + 1))
def test_scripted_sequence_equals_jax(hot):
    """The eviction script of tests/test_serving.py, extended with a
    prefetch, a duplicate get, a drop and a quiesce, at every hot size."""
    p = _Pair(hot)
    for op, blocks, vals in _script_ops(np.random.default_rng(hot)):
        p.op(op, blocks, vals)
    p.check_end()


def test_any_sequence_and_hot_size_equals_jax():
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")
    blocks = st.lists(st.integers(0, N_BLOCKS - 1), min_size=1, max_size=4)
    op = st.tuples(st.sampled_from(["get", "put", "prefetch", "drop",
                                    "quiesce"]), blocks)

    @hyp.settings(max_examples=25, deadline=None)
    @hyp.given(hot=st.integers(1, N_BLOCKS),
               ops=st.lists(op, min_size=1, max_size=8),
               seed=st.integers(0, 2 ** 16))
    def prop(hot, ops, seed):
        rng = np.random.default_rng(seed)
        p = _Pair(hot)
        for name, bl in ops:
            if name == "put":
                bl = list(dict.fromkeys(bl))     # one row per block a put
            p.op(name, bl, _vals(rng, len(bl)))
        p.op("quiesce")
        p.check_end()

    prop()


# ------------------------------------------------ the view regressions ---

def test_hit_evicted_by_a_miss_in_the_same_get():
    """Block 0 is a hit, block 1 a miss that evicts block 0 from the one
    hot slot: the row returned for block 0 is block 0's, not block 1's."""
    p = _Pair(hot_blocks=1)
    v0 = np.full((1, WORDS), 0xDEADBEEF, np.uint32)
    p.op("put", [0], v0)
    want = np.asarray(p.j.get([0, 1]))
    got = p.t.get([0, 1]).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], v0[0])
    np.testing.assert_array_equal(got[1], 0)
    assert p.t.resident_blocks() == [1]
    p.check_end()


def test_dirty_writeback_of_a_refilled_slot():
    """Putting block 1 evicts dirty block 0 from the one hot slot and
    refills that slot: the write-back carries block 0's row."""
    p = _Pair(hot_blocks=1)
    v0 = np.full((1, WORDS), 0x01020304, np.uint32)
    v1 = np.full((1, WORDS), 0xA0B0C0D0, np.uint32)
    p.op("put", [0], v0)
    p.op("put", [1], v1)
    assert p.t.counters["writebacks"] == 1
    np.testing.assert_array_equal(p.t.cold[0].numpy().view(np.uint32),
                                  v0[0])
    p.op("get", [0])
    p.check_end()


# ------------------------------------------------------- the region ------

@pytest.mark.parametrize("hot", [-3, 0, 1, 4, 9])
def test_alloc_tiered_clamps_as_jax(hot):
    a = JPool().alloc_tiered("kv", 8, 4, hot_blocks=hot)
    b = NamPool().alloc_tiered("kv", 8, 4, hot_blocks=hot)
    assert (b.n_blocks, b.block_words, b.hot_blocks, b.hot_fraction) == \
        (a.n_blocks, a.block_words, a.hot_blocks, a.hot_fraction)
    assert b.cold.shape == a.cold.shape and b.cold.dtype == torch.int32


@pytest.mark.parametrize("n,w", [(0, 4), (4, 0)])
def test_alloc_tiered_refuses_as_jax(n, w):
    with pytest.raises(ValueError, match="n_blocks >= 1"):
        JPool().alloc_tiered("kv", n, w, hot_blocks=1)
    with pytest.raises(ValueError, match="n_blocks >= 1"):
        NamPool().alloc_tiered("kv", n, w, hot_blocks=1)


def test_prefetch_is_one_batched_async_read():
    tp = LocalTransport(device="cpu")
    store = TieredStore(NamPool(), tp, "kv", 8, 4, hot_blocks=4)
    assert store.prefetch([0, 1, 2, 3]) == 4
    st = tp.stats()["read_cold"]
    assert (st["calls"], st["msgs"]) == (1, 4)
    store.get([0, 1, 2, 3])                     # lands from pending
    assert store.counters["misses"] == 0 and store.hit_rate() is None
    store.quiesce()
    assert store.stats()["pending"] == 0


# ------------------------------------- the write-back race fixtures ------

def _writeback_then_page_in(tp, rec, u32, i32, signaled):
    cold = u32(np.zeros(32))
    rows = i32([8, 9, 10, 11])                   # block 2's rows
    if signaled:
        tp.write_async(cold, rows, u32(np.ones(4)), region="serve_kv",
                       tier="cold").wait()
    else:
        tp.write(cold, rows, u32(np.ones(4)), region="serve_kv",
                 tier="cold")
    tp.read(cold, rows, region="serve_kv", tier="cold")     # page-in
    return tp


@pytest.mark.parametrize("signaled", [False, True])
def test_writeback_fixtures_report_as_jax(signaled):
    """A plain WRITE-back then a page-in READ of the same rows is an
    rw-race; the signaled write-back (write_async().wait()) fences it.
    The tiered verbs count as write_cold and read_cold in both."""
    jrec, trec = jcheck.ScheduleRecorder(), check.ScheduleRecorder()
    jtp = _writeback_then_page_in(
        JLocal(recorder=jrec), jrec,
        lambda v: jnp.asarray(np.asarray(v, np.uint32)),
        lambda v: jnp.asarray(np.asarray(v, np.int32)), signaled)
    ttp = _writeback_then_page_in(
        LocalTransport(recorder=trec, device="cpu"), trec,
        lambda v: torch.tensor(np.asarray(v, np.uint32).view(np.int32)),
        lambda v: torch.tensor(np.asarray(v, np.int32)), signaled)
    jrep = jcheck.check_schedule(jrec, target="writeback")
    trep = check.check_schedule(trec, target="writeback")
    assert [(v.rule, v.where, v.detail) for v in trep.violations] == \
        [(v.rule, v.where, v.detail) for v in jrep.violations]
    assert [v.rule for v in trep.violations] == \
        ([] if signaled else ["rw-race"])
    for verb in ("write_cold", "read_cold"):
        assert ttp.stats()[verb] == jtp.stats()[verb]
    assert "read" not in ttp.stats() and "write" not in ttp.stats()
