"""The port's RSI commit forms and 2PC against the JAX package's.

One batch (or list of waves, or groups) is drawn with numpy from a seed
and committed by both packages on fresh single-shard transports: the
committed masks, all four store leaves, the per-verb counters and the
plan builds must be identical.  The port updates the store in place, so
it is handed its own copy.  On the CPU it runs its kernels' plain
versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rsi as jrsi
from repro.core import twopc as jtwopc
from repro.fabric import LocalTransport as JaxLocalTransport
from repro_torch._bits import np_u32
from repro_torch.core import rsi, twopc
from repro_torch.fabric import LocalTransport

M = 2                                   # payload words
NUM_TS = 64                             # bitvector slots


def _store(rng, R, slots):
    """A store with live, locked and unborn records."""
    words = rng.integers(0, 4, R).astype(np.uint32)
    words[rng.random(R) < 0.15] |= np.uint32(1 << 31)
    return {"words": words,
            "payload": rng.integers(0, 2 ** 32, (R, slots, M),
                                    dtype=np.uint64).astype(np.uint32),
            "cids": rng.integers(0, 5, (R, slots)).astype(np.uint32),
            "bitvec": rng.random(NUM_TS) < 0.3}


def _batch(rng, store, T, W, cid0):
    """T txns of W write slots: unused slots (-1), repeated records
    (conflicts), mostly valid read cids and some stale ones; the last cid
    falls outside the bitvector (its burn is dropped)."""
    R = store["words"].shape[0]
    recs = rng.integers(-1, R, (T, W)).astype(np.int32)
    cur = store["words"][np.clip(recs, 0, R - 1)] & np.uint32(0x7FFFFFFF)
    rc = np.where(rng.random((T, W)) < 0.8, cur,
                  rng.integers(0, 4, (T, W))).astype(np.uint32)
    cid = (cid0 + np.arange(T)).astype(np.uint32)
    cid[-1] = NUM_TS + 5
    return {"write_recs": recs, "read_cids": rc,
            "new_payload": rng.integers(0, 2 ** 32, (T, W, M),
                                        dtype=np.uint64).astype(np.uint32),
            "cid": cid}


def _jax(store=None, batch=None):
    if batch is not None:
        return jrsi.TxnBatch(**{k: jnp.asarray(v) for k, v in batch.items()})
    return {k: jnp.asarray(v) for k, v in store.items()}


def _port(store=None, batch=None):
    if batch is not None:
        return rsi.TxnBatch.from_numpy(device="cpu", **batch)
    return rsi.store_from_numpy(store, "cpu")


def _prio(p, port):
    if p is None:
        return None
    return torch.from_numpy(p) if port else jnp.asarray(p)


def _assert_same(jok, ok, jstore, store, jtp, tp):
    if isinstance(jok, (list, tuple)):
        assert len(jok) == len(ok)
        for a, b in zip(jok, ok):
            _assert_same(a, b, None, None, None, None)
    else:
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    if jstore is not None:
        got = rsi.store_to_numpy(store)
        for k in rsi.LEAVES:
            np.testing.assert_array_equal(got[k], np.asarray(jstore[k]),
                                          err_msg=k)
    if jtp is not None:
        assert tp.stats() == jtp.stats()
        assert tp.plan_builds == jtp.plan_builds


@pytest.mark.parametrize("isolation", ["rsi", "2pc"])
@pytest.mark.parametrize("slots", [1, 2])
@pytest.mark.parametrize("prio_kind,chunks", [("default", 1), ("perm", 1),
                                              ("ties", 2)])
def test_commit_matches_jax(isolation, slots, prio_kind, chunks):
    rng = np.random.default_rng(slots * 10 + chunks)
    store = _store(rng, 30, slots)
    T, W = 12, 3
    batch = _batch(rng, store, T, W, cid0=6)
    prio = {"default": None,
            "perm": rng.permutation(T).astype(np.int32),
            "ties": rng.integers(-2, 2, T).astype(np.int32)}[prio_kind]
    jfn, fn = ((jrsi.commit, rsi.commit) if isolation == "rsi"
               else (jtwopc.commit, twopc.commit))
    jtp, tp = JaxLocalTransport(), LocalTransport(device="cpu")
    jok, jst = jfn(_jax(store), _jax(batch=batch), transport=jtp,
                   priority=_prio(prio, False), chunks=chunks)
    mine = _port(store)
    ok, st = fn(mine, _port(batch=batch), transport=tp,
                priority=_prio(prio, True), chunks=chunks)
    assert st["words"] is mine["words"]       # updated in place
    assert 0 < int(ok.sum()) < T              # both outcomes exercised
    _assert_same(jok, ok, jst, st, jtp, tp)
    assert tp.plan_builds == 1 and tp.stats()["route"]["calls"] == 2


@pytest.mark.parametrize("slots", [1, 2])
def test_commit_pipelined_matches_jax(slots):
    rng = np.random.default_rng(40 + slots)
    store = _store(rng, 24, slots)
    waves = [_batch(rng, store, T, W, cid0)
             for T, W, cid0 in ((6, 3, 4), (8, 2, 12), (5, 3, 22))]
    jtp, tp = JaxLocalTransport(), LocalTransport(device="cpu")
    joks, jst = jrsi.commit_pipelined(
        _jax(store), [_jax(batch=b) for b in waves], transport=jtp)
    oks, st = rsi.commit_pipelined(
        _port(store), [_port(batch=b) for b in waves], transport=tp)
    _assert_same(joks, oks, jst, st, jtp, tp)
    assert tp.plan_builds == 3


def test_commit_pipelined_equals_sequential_commits():
    rng = np.random.default_rng(5)
    store = _store(rng, 20, 2)
    waves = [_batch(rng, store, 6, 3, c) for c in (4, 12)]
    oks, st = rsi.commit_pipelined(_port(store),
                                   [_port(batch=b) for b in waves])
    seq = _port(store)
    for b, ok in zip(waves, oks):
        got, seq = rsi.commit(seq, _port(batch=b))
        assert torch.equal(got, ok)
    for k in rsi.LEAVES:
        assert torch.equal(seq[k], st[k]), k


@pytest.mark.parametrize("slots", [1, 2])
@pytest.mark.parametrize("same_w", [True, False])
def test_commit_grouped_matches_jax(slots, same_w):
    rng = np.random.default_rng(60 + slots + 2 * same_w)
    store = _store(rng, 24, slots)
    shapes = ((3, 2), (2, 2), (3, 2)) if same_w else ((3, 2), (2, 3), (1, 1))
    groups, cid0 = [], 4
    for T, W in shapes:
        groups.append(_batch(rng, store, T, W, cid0))
        cid0 += T
    prio = [rng.permutation(T).astype(np.int32) + 10 * i
            for i, (T, _) in enumerate(shapes)]
    jtp, tp = JaxLocalTransport(), LocalTransport(device="cpu")
    joks, jst = jrsi.commit_grouped(
        _jax(store), [_jax(batch=b) for b in groups], transport=jtp,
        priority=[jnp.asarray(p) for p in prio])
    oks, st = rsi.commit_grouped(
        _port(store), [_port(batch=b) for b in groups], transport=tp,
        priority=[torch.from_numpy(p) for p in prio])
    _assert_same(joks, oks, jst, st, jtp, tp)
    assert tp.plan_builds == 1


def test_commit_grouped_pipelined_matches_jax():
    rng = np.random.default_rng(77)
    store = _store(rng, 30, 2)
    waves, cid0 = [], 4
    for shapes in (((2, 2), (2, 2)), ((3, 2), (1, 2), (2, 2))):
        wave = []
        for T, W in shapes:
            wave.append(_batch(rng, store, T, W, cid0))
            cid0 += T
        waves.append(wave)
    jtp, tp = JaxLocalTransport(), LocalTransport(device="cpu")
    joks, jst = jrsi.commit_grouped_pipelined(
        _jax(store), [[_jax(batch=b) for b in w] for w in waves],
        transport=jtp)
    oks, st = rsi.commit_grouped_pipelined(
        _port(store), [[_port(batch=b) for b in w] for w in waves],
        transport=tp)
    assert len(oks) == len(joks)
    for jo, o in zip(joks, oks):
        _assert_same(jo, o, None, None, None, None)
    _assert_same(joks[0], oks[0], jst, st, jtp, tp)


@pytest.mark.parametrize("slots", [1, 3])
def test_read_snapshot_and_highest_committed_match_jax(slots):
    rng = np.random.default_rng(slots)
    store = _store(rng, 16, slots)
    store["cids"][3] = np.uint32(0xFFFFFFF0)          # u32 order matters
    recs = rng.integers(0, 16, (4, 5)).astype(np.int32)
    jtp, tp = JaxLocalTransport(), LocalTransport(device="cpu")
    for rid in (0, 2, 3, 0xFFFFFFF5):
        jout = jrsi.read_snapshot(_jax(store), jnp.asarray(recs),
                                  jnp.uint32(rid), transport=jtp)
        out = rsi.read_snapshot(_port(store), torch.from_numpy(recs), rid,
                                transport=tp)
        for a, b in zip(jout, out):
            np.testing.assert_array_equal(np_u32(b) if b.dtype ==
                                          torch.int32 else b.numpy(),
                                          np.asarray(a))
    assert tp.stats() == jtp.stats()
    bv = store["bitvec"].copy()
    bv[:7] = True
    want = int(np.cumprod(bv).sum())
    assert want >= 7
    assert int(rsi.highest_committed(torch.from_numpy(bv))) == want
    assert int(jrsi.highest_committed(jnp.asarray(bv))) == want


def test_store_and_batch_round_trip_bits():
    rng = np.random.default_rng(9)
    store = _store(rng, 10, 2)
    back = rsi.store_to_numpy(_port(store))
    for k in rsi.LEAVES:
        assert back[k].dtype == store[k].dtype
        np.testing.assert_array_equal(back[k], store[k])
    cfg = rsi.StoreCfg(num_records=5, payload_words=3, version_slots=2,
                       num_timestamps=8)
    empty = rsi.init_store(cfg, "cpu")
    jempty = jrsi.init_store(jrsi.StoreCfg(num_records=5, payload_words=3,
                                           version_slots=2,
                                           num_timestamps=8))
    for k in rsi.LEAVES:
        np.testing.assert_array_equal(rsi.store_to_numpy(empty)[k],
                                      np.asarray(jempty[k]))
