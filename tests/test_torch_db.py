"""The slice as a whole: the port's Database facade against the JAX
package's ``Database(jit=False)``.

A small TPC-W checkout (paper §4.3: read 3 products, update 3 stocks,
insert 4 rows) runs through ``Session.begin/get/put`` and
``Database.commit`` with bounded retry on both packages, from the same
numpy draw.  Hot products are forced into some sessions so waves abort
and retry.  Eager JAX counts every verb call, as the port does, so the
counters must match as well as the outcomes and every store leaf.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.db import Database as JaxDatabase
from repro_torch._bits import np_u32
from repro_torch.core import rsi
from repro_torch.db import Database

PRODUCTS, M, T, WAVES = 2000, 4, 64, 3
HOT = (0, 1)


def _plan(seed=0, waves=WAVES, t=T):
    """Per wave: products (t, 3) with hot rows forced into every 8th
    session, fresh insert rows (t, 4), payload deltas (t, 7, M)."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(waves):
        prods = np.stack([rng.choice(PRODUCTS, 3, replace=False)
                          for _ in range(t)]).astype(np.int32)
        prods[::8, :2] = HOT
        ins = (PRODUCTS + (w * t + np.arange(t))[:, None] * 4
               + np.arange(4)[None, :]).astype(np.int32)
        pay = rng.integers(0, 2 ** 32, (t, 7, M), dtype=np.uint64).astype(
            np.uint32)
        out.append((prods, ins, pay))
    return out


def _to_np(x):
    return np_u32(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _checkout(db, plan, *, commit="commit", isolation="rsi",
              max_retries=1):
    t = db.create_table("products", PRODUCTS + len(plan) * T * 4,
                        payload_words=M, num_timestamps=4096)
    t.seed(np.arange(PRODUCTS),
           np.arange(PRODUCTS * M, dtype=np.uint32).reshape(PRODUCTS, M))
    masks, waves = [], []
    for prods, ins, pay in plan:
        sessions = []
        for i in range(prods.shape[0]):
            s = db.session(isolation=isolation).begin()
            cur, rcids, ok = s.get("products", prods[i])
            assert bool(np.all(_to_np(ok)))
            s.put("products", prods[i], _to_np(cur) + pay[i, :3], rcids)
            s.put("products", ins[i], pay[i, 3:])
            sessions.append(s)
        waves.append(sessions)
        if commit == "commit":
            masks.append(db.commit(sessions, max_retries=max_retries))
    if commit == "pipelined":
        masks = db.commit_pipelined(waves, max_retries=max_retries)
    elif commit == "grouped":
        for sessions in waves:
            masks += db.commit_grouped(
                [sessions[i:i + 16] for i in range(0, len(sessions), 16)],
                max_retries=max_retries)
    return masks, [s for w in waves for s in w]


def _assert_same_db(jdb, db, jmasks, masks):
    assert len(jmasks) == len(masks)
    for a, b in zip(jmasks, masks):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert db.txn_stats == jdb.txn_stats
    assert db.fabric_stats() == jdb.fabric_stats()
    assert db.read_timestamp() == jdb.read_timestamp()
    got = rsi.store_to_numpy(db.table("products").store)
    for k in rsi.LEAVES:
        np.testing.assert_array_equal(
            got[k], np.asarray(jdb.table("products").store[k]), err_msg=k)


@pytest.mark.parametrize("isolation", ["rsi", "2pc"])
def test_checkout_waves_with_retry_match_jax(isolation):
    plan = _plan()
    jdb = JaxDatabase(jit=False)
    jmasks, _ = _checkout(jdb, plan, isolation=isolation)
    db = Database(device="cpu")
    masks, sessions = _checkout(db, plan, isolation=isolation)
    _assert_same_db(jdb, db, jmasks, masks)
    st = db.txn_stats
    assert st["aborts"] > 0 and st["retries"] > 0      # hot rows contended
    final_aborts = sum(int((~m).sum()) for m in masks)
    assert st["commits"] + final_aborts == WAVES * T
    assert st["commits"] + st["aborts"] == sum(s.attempts for s in sessions)
    assert db.table("products").locked_rows() == 0


@pytest.mark.parametrize("commit", ["pipelined", "grouped"])
def test_pipelined_and_grouped_facade_match_jax(commit):
    plan = _plan(seed=1, waves=2, t=32)
    jdb = JaxDatabase(jit=False)
    jmasks, _ = _checkout(jdb, plan, commit=commit)
    db = Database(device="cpu")
    masks, _ = _checkout(db, plan, commit=commit)
    _assert_same_db(jdb, db, jmasks, masks)


def test_committed_writes_read_back():
    db = Database(device="cpu")
    masks, sessions = _checkout(db, _plan(seed=2, waves=2, t=32),
                               max_retries=2)
    last = {}
    for s in sorted((s for s in sessions if s.committed),
                    key=lambda s: s.cid):
        recs, pay, _ = s.writes()
        for r, p in zip(recs, pay):
            last[int(r)] = (s.cid, p)
    recs = np.fromiter(last, np.int32)
    pay, cid, ok = db.snapshot_read("products", recs)
    assert bool(ok.all())
    np.testing.assert_array_equal(np_u32(pay),
                                  np.stack([last[int(r)][1] for r in recs]))
    np.testing.assert_array_equal(np_u32(cid),
                                  [last[int(r)][0] for r in recs])
    # at its own cid every last writer's version is visible
    for r in recs[:20]:
        c, p = last[int(r)]
        pay, _, ok = db.snapshot_read("products", [r], rid=c)
        assert bool(ok[0]) and np.array_equal(np_u32(pay)[0], p)


def test_session_guards_and_readonly():
    db = Database(device="cpu")
    t = db.create_table("a", 8, payload_words=1)
    t.seed(np.arange(8))
    db.create_table("b", 8, payload_words=1)
    s = db.session()
    with pytest.raises(RuntimeError, match="begin"):
        s.get("a", [0])
    s.begin()
    s.put("a", [0], np.ones((1, 1), np.uint32))
    with pytest.raises(NotImplementedError, match="multi-table"):
        s.put("b", [0], np.ones((1, 1), np.uint32))
    with pytest.raises(ValueError, match="isolation"):
        db.session(isolation="3pc")
    ro = db.session().begin()
    ro.get("a", [1, 2])
    w1 = db.session().begin()
    w1.put("a", [2], np.array([[9]]), read_cids=np.ones(1, np.uint32))
    w2 = db.session().begin()                 # conflicting write loses
    w2.put("a", [2], np.array([[8]]), read_cids=np.ones(1, np.uint32))
    np.testing.assert_array_equal(db.commit([w1, ro, w2]),
                                  [True, True, False])
    assert ro.committed and ro.cid is None
    with pytest.raises(ValueError, match="mixed"):
        db.commit([db.session().begin().put("a", [3], [[1]]),
                   db.session("2pc").begin().put("a", [4], [[1]])])


def test_oracle_and_session_commit_match_jax():
    dbs = (JaxDatabase(jit=False), Database(device="cpu"))
    for d in dbs:
        t = d.create_table("acct", 16, payload_words=1)
        t.seed(np.arange(4), np.full((4, 1), 100))
        np.testing.assert_array_equal(d.claim_cids(3), [2, 3, 4])
        s = d.session().begin()
        pay, rids, _ = s.get("acct", [0, 1])
        s.put("acct", [0, 1], _to_np(pay) + 11, read_cids=rids)
        assert s.commit()
        stale = d.session().begin()
        stale.put("acct", [0], [[5]], read_cids=_to_np(rids)[:1])
        assert not stale.commit()
        assert stale.refresh_read_cids().commit()   # revalidated
    jdb, db = dbs
    assert db.fabric_stats() == jdb.fabric_stats()
    assert db.read_timestamp() == jdb.read_timestamp() == 7


def test_lock_column_claim_release_matches_jax():
    outs = []
    for d in (JaxDatabase(jit=False), Database(device="cpu")):
        t = d.create_table("slots", 6, payload_words=1)
        got = [t.claim_locks(4), t.locked_rows()]
        got += [t.claim_locks(4), t.locked_rows()]
        t.release_lock(1, signaled=True)
        got += [t.locked_rows(), t.claim_locks(1)]
        t.release_lock(2)
        got += [t.locked_rows()]
        data = d.create_table("data", 6, payload_words=1)
        data.seed(np.arange(3))
        with pytest.raises(ValueError, match="data table"):
            data.claim_locks(1)
        outs.append((got, d.fabric_stats(),
                     np.asarray(_to_np(t.store["words"]))))
    (jgot, jstats, jwords), (got, stats, words) = outs
    assert got == jgot == [[0, 1, 2, 3], 4, [4, 5], 6, 5, [1], 5]
    assert stats == jstats
    np.testing.assert_array_equal(words, jwords)
