"""The port's n-shard fabric (``MeshTransport`` on one device) against the
JAX package's ``MeshTransport`` on a 4-device CPU mesh.

The JAX side runs once, in a subprocess that sets
``--xla_force_host_platform_device_count=4`` before it imports ``jax``
(as ``tests/test_multidevice.py`` does), so this process keeps one
device.  Inputs are drawn once with numpy from a seed and fed to both
packages; the subprocess writes its outputs to an ``.npz`` and its
transports' counters to a JSON file.  Every comparison is exact: routes
in their three modes, the raw commit in its three forms, the four joins
and both aggregations, values and per-verb counters.  The port's n = 4
facade is held to the JAX commit under ``LocalTransport`` in this
process.  The last tests hold the emulation itself: shard indices,
collectives against numpy, failures that must surface instead of
hanging, and the counting rule (once per body, as JAX counts at trace
time).
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rsi as jrsi
from repro_torch._bits import np_u32
from repro_torch.bench import checkout, fig6_rsi, fig8a_joins, fig8b_agg
from repro_torch.core import aggregation, rsi, shuffle
from repro_torch.db import Database
from repro_torch.fabric import (LocalTransport, MeshTransport, ShardFailure,
                                chunked_all_to_all)

N = 4                                   # shards
ROOT = Path(__file__).resolve().parents[1]
CAP, A = 12, 40                         # the route: test_async's mesh script
R_RECS, T, M, NUM_TS = 32, 16, 2, 64    # the commits: test_multidevice[rsi]
JOINS = ("ghj", "ghj_bloom", "rdma_ghj", "rrj")
AGG_GROUPS = (2, 64)                    # one below n: an owner a group

_ORACLE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.core import aggregation, rsi, shuffle
from repro.fabric import MeshTransport

src, dst = sys.argv[1], sys.argv[2]
d = dict(np.load(os.path.join(src, "inputs.npz")))
mesh = jax.make_mesh((4,), ("data",))
out, stats = {}, {}

def tp():
    return MeshTransport(mesh, "data")

def save(name, t, values):
    for i, v in enumerate(values):
        out[f"{name}/{i}"] = np.asarray(v)
    stats[name] = {"stats": t.stats(), "plan_builds": t.plan_builds}

for mode in ("sync", "overlap", "async"):
    t = tp()
    def body(k, v, dst_):
        f = {"k": k, "v": v}
        if mode == "sync":
            r = t.route(f, dst_, cap=12, chunks=3)
        elif mode == "overlap":
            r = t.route(f, dst_, cap=12, chunks=3, overlap=True)
        else:
            r = t.route_async(f, dst_, cap=12, chunks=3).wait()
        return (r.fields["k"], r.fields["v"], r.valid,
                r.dropped.reshape(1), r.sent["k"], r.sent_valid)
    save(f"route/{mode}", t, jax.jit(lambda k, v, dd: t.run(
        body, (k, v, dd),
        out_reps=(False, False, False, True, False, False)))(
            jnp.asarray(d["route_k"]), jnp.asarray(d["route_v"]),
            jnp.asarray(d["route_dest"])))

def store():
    return {k: jnp.asarray(d["store_" + k])
            for k in ("words", "payload", "cids", "bitvec")}

def batch(p):
    return rsi.TxnBatch(**{k: jnp.asarray(d[p + k]) for k in
                           ("write_recs", "read_cids", "new_payload", "cid")})

def leaves(st):
    return [st[k] for k in ("words", "payload", "cids", "bitvec")]

# every call jitted: eager shard_map bodies dispatch op by op and take
# ten times as long; the counters count at trace time either way
t = tp()
ok, st = jax.jit(lambda s, b, p: rsi.commit(s, b, transport=t, priority=p))(
    store(), batch("c_"), jnp.asarray(d["c_prio"]))
save("commit", t, [ok] + leaves(st))
# commit_grouped's own body: its split of the sharded mask by slicing
# raises a sharding error under JAX 0.9, so the split happens in numpy
t = tp()
groups = [batch(f"g{i}_") for i in range(4)]
gch = rsi._group_chunks(groups, None)
b, prio, sizes = rsi.concat_group(groups)
ok, st = jax.jit(lambda s, b, p: rsi.commit(
    s, b, transport=t, priority=p, chunks=gch, exchange_chunks=gch))(
        store(), b, prio)
save("grouped", t, np.split(np.asarray(ok), np.cumsum(sizes)[:-1])
     + leaves(st))
t = tp()
oks, st = jax.jit(lambda s, w: rsi.commit_pipelined(
    s, w, transport=t, chunks=2))(store(), [batch(f"p{i}_") for i in range(3)])
save("pipelined", t, list(oks) + leaves(st))

rel = [jnp.asarray(d[k]) for k in ("rk", "rv", "sk", "sv")]
for variant in ("ghj", "ghj_bloom", "rdma_ghj", "rrj"):
    t = tp()
    save(f"join/{variant}", t, jax.jit(shuffle.make_distributed_join(
        t, variant, return_stats=True))(*rel))
for G in (2, 64):
    for scheme in ("dist_agg", "rdma_agg"):
        t = tp()
        save(f"agg/{scheme}/{G}", t, [jax.jit(getattr(aggregation, scheme)(
            t, G))(jnp.asarray(d["keys"]), jnp.asarray(d["vals"]))])
np.savez(os.path.join(dst, "outputs.npz"), **out)
with open(os.path.join(dst, "stats.json"), "w") as f:
    json.dump(stats, f)
print("MESH_ORACLE_OK")
"""


def _store_np(rng, slots=2):
    """32 records: live, locked and unborn, some with a history."""
    words = rng.integers(0, 4, R_RECS).astype(np.uint32)
    words[rng.random(R_RECS) < 0.15] |= np.uint32(1 << 31)
    return {"words": words,
            "payload": rng.integers(0, 2 ** 32, (R_RECS, slots, M),
                                    dtype=np.uint64).astype(np.uint32),
            "cids": rng.integers(0, 5, (R_RECS, slots)).astype(np.uint32),
            "bitvec": rng.random(NUM_TS) < 0.3}


def _batch_np(rng, store, t, w, cid0):
    """t txns of w write slots: unused slots, conflicts, stale read cids;
    cids spread over every shard's range of the bitvector and past it."""
    recs = rng.integers(-1, R_RECS, (t, w)).astype(np.int32)
    cur = store["words"][np.clip(recs, 0, R_RECS - 1)] & np.uint32(
        0x7FFFFFFF)
    rc = np.where(rng.random((t, w)) < 0.8, cur,
                  rng.integers(0, 4, (t, w))).astype(np.uint32)
    cid = (cid0 + 4 * np.arange(t)).astype(np.uint32)
    cid[-1] = NUM_TS + 5
    return {"write_recs": recs, "read_cids": rc,
            "new_payload": rng.integers(0, 2 ** 32, (t, w, M),
                                        dtype=np.uint64).astype(np.uint32),
            "cid": cid}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(18)
    d = {"route_k": rng.integers(0, 99, A).astype(np.uint32),
         "route_v": rng.standard_normal((A, 2)).astype(np.float32),
         "route_dest": rng.integers(-1, N + 1, A).astype(np.int32)}
    store = _store_np(rng)
    d.update({"store_" + k: v for k, v in store.items()})
    d.update({"c_" + k: v for k, v in
              _batch_np(rng, store, T, 3, 1).items()})
    d["c_prio"] = rng.permutation(T).astype(np.int32)
    for i in range(4):                  # 4 sessions a group, W of 2 or 3
        d.update({f"g{i}_" + k: v for k, v in _batch_np(
            rng, store, 4, 2 + i % 2, 1 + i).items()})
    for i in range(3):                  # 3 dependent waves
        d.update({f"p{i}_" + k: v for k, v in _batch_np(
            rng, store, T, 2, 1 + i).items()})
    rk = rng.permutation(np.arange(1, 2049, dtype=np.uint32))
    sk = rng.integers(1, 4096, 4096).astype(np.uint32)
    d.update(rk=rk, rv=rk * np.uint32(3), sk=sk,
             sv=np.full(4096, 2, np.uint32),
             keys=rng.integers(0, 2 ** 32, 4096,
                               dtype=np.uint64).astype(np.uint32),
             vals=rng.integers(0, 2 ** 32, 4096,
                               dtype=np.uint64).astype(np.uint32))
    return d


@pytest.fixture(scope="module")
def oracle(inputs, tmp_path_factory):
    """The JAX package's outputs and counters on a 4-device mesh."""
    tmp = tmp_path_factory.mktemp("mesh_oracle")
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _ORACLE, str(tmp), str(tmp)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert "MESH_ORACLE_OK" in r.stdout, r.stderr[-3000:]
    out = dict(np.load(tmp / "outputs.npz"))
    return out, json.loads((tmp / "stats.json").read_text())


def _t(a):
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _np(x) -> np.ndarray:
    """A port tensor in the JAX package's dtype (int32 words as u32)."""
    a = x.detach().cpu().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _check(name, got, t, oracle, *, u32=()):
    """Outputs (in order) and counters equal the JAX run ``name``.  The
    positions in ``u32`` carry u32 words in JAX and int32 ones in the
    port (booleans and float lanes compare as they are)."""
    out, stats = oracle
    want = [out[f"{name}/{i}"] for i in range(len(got))]
    assert f"{name}/{len(got)}" not in out
    for i, (g, w) in enumerate(zip(got, want)):
        g = _np(g)
        if i not in u32 and g.dtype == np.uint32:
            g = g.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=f"{name} output {i}")
    assert json.loads(json.dumps(t.stats())) == stats[name]["stats"]
    assert t.plan_builds == stats[name]["plan_builds"]


def _mesh():
    return MeshTransport(N, device="cpu")


# ------------------------------------------------ parity with JAX's mesh --

@pytest.mark.parametrize("mode", ["sync", "overlap", "async"])
def test_routes_match_jax_mesh(inputs, oracle, mode):
    t = _mesh()

    def body(k, v, dst):
        f = {"k": k, "v": v}
        if mode == "async":
            r = t.route_async(f, dst, cap=CAP, chunks=3).wait()
        else:
            r = t.route(f, dst, cap=CAP, chunks=3, overlap=mode == "overlap")
        return (r.fields["k"], r.fields["v"], r.valid,
                r.dropped.reshape(1), r.sent["k"], r.sent_valid)

    got = t.run(body, (_t(inputs["route_k"]), _t(inputs["route_v"]),
                       _t(inputs["route_dest"])),
                out_reps=(False, False, False, True, False, False))
    _check(f"route/{mode}", got, t, oracle, u32=(0, 4))


def _store(inputs):
    return rsi.store_from_numpy(
        {k: inputs["store_" + k] for k in rsi.LEAVES}, "cpu")


def _batch(inputs, p):
    return rsi.TxnBatch.from_numpy(device="cpu", **{
        k: inputs[p + k] for k in ("write_recs", "read_cids", "new_payload",
                                   "cid")})


@pytest.mark.parametrize("form", ["commit", "grouped", "pipelined"])
def test_raw_commits_match_jax_mesh(inputs, oracle, form):
    t = _mesh()
    store = _store(inputs)
    if form == "commit":
        ok, st = rsi.commit(store, _batch(inputs, "c_"), transport=t,
                            priority=_t(inputs["c_prio"]))
        oks = [ok]
    elif form == "grouped":
        oks, st = rsi.commit_grouped(
            store, [_batch(inputs, f"g{i}_") for i in range(4)], transport=t)
    else:
        oks, st = rsi.commit_pipelined(
            store, [_batch(inputs, f"p{i}_") for i in range(3)], transport=t,
            chunks=2)
    # the store is updated in place: the same tensors come back
    assert all(st[k] is store[k] for k in rsi.LEAVES)
    k = len(oks)
    _check(form, list(oks) + [st[k] for k in rsi.LEAVES], t, oracle,
           u32=range(k, k + 3))


@pytest.mark.parametrize("variant", JOINS)
def test_joins_match_jax_mesh(inputs, oracle, variant):
    t = _mesh()
    agg, dropped = shuffle.make_distributed_join(
        t, variant, return_stats=True)(
            *[_t(inputs[k]) for k in ("rk", "rv", "sk", "sv")])
    _check(f"join/{variant}", [agg, dropped], t, oracle, u32=(0,))
    sk = inputs["sk"].astype(np.uint64)
    assert int(np_u32(agg)) == int(np.sum(np.where(sk <= 2048, sk * 6, 0))
                                   % 2 ** 32)


@pytest.mark.parametrize("groups", AGG_GROUPS)
@pytest.mark.parametrize("scheme", ["dist_agg", "rdma_agg"])
def test_aggregations_match_jax_mesh(inputs, oracle, scheme, groups):
    t = _mesh()
    got = getattr(aggregation, scheme)(t, groups)(_t(inputs["keys"]),
                                                  _t(inputs["vals"]))
    _check(f"agg/{scheme}/{groups}", [got], t, oracle, u32=(0,))
    local = getattr(aggregation, scheme)(LocalTransport(device="cpu"),
                                         groups)(_t(inputs["keys"]),
                                                 _t(inputs["vals"]))
    assert torch.equal(got, local)


# ------------------------------------------------------------ the facade --

def _facade_sessions(db, recs, pay):
    tab = db.create_table("t", R_RECS, payload_words=2, num_timestamps=64)
    tab.seed(np.arange(R_RECS))
    sessions = []
    for i in range(recs.shape[0]):
        s = db.session().begin()
        s.put("t", recs[i], pay[i], read_cids=np.ones(2, np.uint32))
        sessions.append(s)
    return tab, db.commit(sessions)


def test_facade_matches_jax_local_commit():
    """test_multidevice[rsi]'s 16 sessions on 4 shards: the facade's
    bitvector completion makes the n-shard store equal the JAX commit
    under LocalTransport, bitvec included, and the port's one-shard
    facade."""
    nrec = R_RECS
    jstore = jrsi.init_store(jrsi.StoreCfg(num_records=nrec, payload_words=2,
                                           version_slots=1,
                                           num_timestamps=64))
    jstore["words"] = jnp.full((nrec,), 1, jnp.uint32)
    jstore["cids"] = jstore["cids"].at[:, 0].set(1)
    rng = np.random.RandomState(0)
    recs = np.stack([rng.permutation(nrec)[:2] for _ in range(T)])
    pay = rng.randint(1, 99, (T, 2, 2)).astype(np.uint32)
    jok, jst = jrsi.commit(jstore, jrsi.TxnBatch(
        write_recs=jnp.asarray(recs, jnp.int32),
        read_cids=jnp.full((T, 2), 1, jnp.uint32),
        new_payload=jnp.asarray(pay),
        cid=jnp.asarray(2 + np.arange(T), jnp.uint32)))
    db = Database(transport=_mesh())
    assert db.planner.nodes == N
    tab, ok = _facade_sessions(db, recs, pay)
    db1 = Database(device="cpu")
    tab1, ok1 = _facade_sessions(db1, recs, pay)
    np.testing.assert_array_equal(ok, np.asarray(jok))
    np.testing.assert_array_equal(ok, ok1)
    got, got1 = rsi.store_to_numpy(tab.store), rsi.store_to_numpy(tab1.store)
    for k in rsi.LEAVES:
        np.testing.assert_array_equal(got[k], np.asarray(jst[k]), err_msg=k)
        np.testing.assert_array_equal(got[k], got1[k], err_msg=k)
    # the completion is one counted WRITE of the wave's cids
    assert db.fabric_stats()["write"]["calls"] == (
        db1.fabric_stats()["write"]["calls"] + 1)


def test_facade_refuses_what_does_not_shard():
    db = Database(transport=_mesh())
    with pytest.raises(ValueError, match="4 shards"):
        db.create_table("a", 30, num_timestamps=64)
    with pytest.raises(ValueError, match="4 shards"):
        db.create_table("b", 32, num_timestamps=62)
    tab = db.create_table("t", 32, payload_words=2, num_timestamps=64)
    tab.seed(np.arange(32))
    sessions = [db.session().begin().put("t", [i], np.ones((1, 2),
                                                           np.uint32))
                for i in range(3)]
    with pytest.raises(ValueError, match="4 shards"):
        db.commit(sessions)
    assert db.fabric_stats().get("fetch_add") is None   # no cid claimed
    # retries come in power-of-two waves: 3 losers retry as 2 + 1, and a
    # wave of 2 cannot split over 4 shards (nor can it in the JAX package)
    hot = [db.session().begin().put("t", [0], np.ones((1, 2), np.uint32),
                                    read_cids=[1]) for _ in range(4)]
    assert db.commit(hot).tolist() == [True, False, False, False]
    again = [db.session().begin().put("t", [1], np.ones((1, 2), np.uint32),
                                      read_cids=[1]) for _ in range(4)]
    with pytest.raises(ValueError, match="wave of 2 writer sessions"):
        db.commit(again, max_retries=1)


def test_bench_modules_on_four_shards():
    """The same data on one shard and on four: the checkout waves give
    the same masks, store and txn_stats; fig6 commits the same; fig8a's
    joins and fig8b's aggregations meet their ground truths (the bench
    functions raise otherwise)."""
    plan = checkout.plan(seed=5, waves=2, T=32, products=200,
                         payload_words=4)
    for prods, _, _ in plan:
        prods[::4, :2] = (0, 1)         # hot rows: some sessions abort
    runs = []
    for shards in (1, N):
        db = checkout.database(shards, device="cpu")
        checkout.create_table(db, products=200, waves=2, T=32,
                              payload_words=4)
        masks, sessions, _ = checkout.drive(db, plan, max_retries=0)
        runs.append((db, masks))
        checkout.check_readback(db, sessions, sample=8)
    (db1, m1), (db4, m4) = runs
    assert db4.txn_stats == db1.txn_stats and db1.txn_stats["aborts"] > 0
    assert all(np.array_equal(a, b) for a, b in zip(m1, m4))
    for k in rsi.LEAVES:
        assert torch.equal(db1.table("products").store[k],
                           db4.table("products").store[k]), k
    assert (db4.fabric_stats()["route"]["msgs"]
            == N * db1.fabric_stats()["route"]["msgs"])
    kw = {**fig6_rsi.paper_width(32), "num_records": 2000 + 128,
          "seeded": 2000, "products": 2000, "insert_base": 2000,
          "payload_words": 16}
    r1, r4 = (fig6_rsi.measured_local_txn_rate(iters=2, device="cpu",
                                               shards=s, **kw)
              for s in (1, N))
    assert r4["committed"] == r1["committed"] > 0 and r4["shards"] == N
    assert len(r4["host_times_s"]) == 2
    a = fig8a_joins.joins(4096, device="cpu", sels=(0.5,), timed=1,
                          plain_sels=(0.5,), shards=N)
    assert a["shards"] == N
    assert all(v["dropped"] == 0 for v in a["rows"][0]["variants"].values())
    keys, vals = fig8b_agg.table(4096, device="cpu")
    b = fig8b_agg.aggregations(keys, vals, groups=(2, 64), timed=1,
                               shards=N)
    assert [r["groups"] for r in b["rows"]] == [2, 64]


# ---------------------------------------------------- the emulation itself --

def test_shard_index_and_collectives_match_numpy():
    rng = np.random.default_rng(1)
    x = rng.integers(-2 ** 31, 2 ** 31, (N * 3, 5)).astype(np.int32)
    t = _mesh()
    assert t.n == N and t.axis == "data"

    def body(xb):
        me = t.shard_index()
        return (torch.full((1,), me), t.psum(xb), t.all_gather(xb),
                t.exchange(xb.repeat(N, 1)[:N * 3], chunks=3))

    me, s, g, e = t.run(body, (torch.from_numpy(x),),
                        out_reps=(False, True, True, False))
    assert me.tolist() == list(range(N))
    blocks = x.reshape(N, 3, 5)
    want = blocks.astype(np.int64).sum(0)
    want = ((want + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
    np.testing.assert_array_equal(s.numpy(), want)    # wraps at 2**32
    np.testing.assert_array_equal(g.numpy(), x)
    # each shard sends (its 3 rows repeated) N*3 rows; shard i gets row
    # block i of every sender: row i of each sender's 3 rows... per cap 3
    sent = [np.tile(b, (N, 1))[:N * 3] for b in blocks]
    recv = [np.concatenate([sent[j][i * 3:(i + 1) * 3] for j in range(N)])
            for i in range(N)]
    np.testing.assert_array_equal(e.numpy(), np.concatenate(recv))
    stats = t.stats()
    assert stats["psum"] == {"calls": 1, "msgs": N, "bytes": 60,
                             "peak_outstanding": N, "queue_hist": {"0": 1}}
    assert stats["all_gather"]["bytes"] == N * 60
    assert stats["exchange"]["msgs"] == N * 3
    with pytest.raises(RuntimeError, match="outside"):
        t.shard_index()


@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_chunked_all_to_all_matches_numpy(chunks):
    rng = np.random.default_rng(chunks)
    cap = 4
    bufs = rng.integers(0, 1000, (N, N * cap, 2)).astype(np.int32)
    t = _mesh()
    got = t.run(lambda v: chunked_all_to_all(v[0], t, N, cap, chunks),
                (torch.from_numpy(bufs),), out_reps=False)
    want = np.concatenate([bufs[:, i * cap:(i + 1) * cap].reshape(-1, 2)
                           for i in range(N)])
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="not divisible"):
        t.run(lambda v: chunked_all_to_all(v[0], t, N, cap, 3),
              (torch.from_numpy(bufs),), out_reps=False)


def test_a_failing_shard_raises_within_seconds():
    t = MeshTransport(N, device="cpu", timeout=30)

    def body(x):
        if t.shard_index() == 2:
            raise KeyError("shard 2 broke")
        return t.psum(x)

    t0 = time.perf_counter()
    with pytest.raises(KeyError, match="shard 2 broke"):
        t.run(body, (torch.zeros(N),), out_reps=True)
    assert time.perf_counter() - t0 < 5
    # the transport runs again afterwards
    assert t.run(lambda x: t.psum(x), (torch.ones(N),),
                 out_reps=True).item() == N


def test_a_barrier_times_out_instead_of_hanging():
    t = MeshTransport(N, device="cpu", timeout=0.5)

    def body(x):
        if t.shard_index() == 1:
            time.sleep(2)              # late past the others' time limit
        return t.psum(x)

    t0 = time.perf_counter()
    with pytest.raises(ShardFailure, match="waited past 0.5 s"):
        t.run(body, (torch.zeros(N),), out_reps=True)
    assert time.perf_counter() - t0 < 10


def test_mismatched_collectives_raise():
    t = _mesh()

    def body(x):
        if t.shard_index() == 3:
            return t.all_gather(x)     # a data-dependent branch
        return t.psum(x)

    with pytest.raises(ShardFailure, match="different collectives"):
        t.run(body, (torch.zeros(N),), out_reps=True)

    def early(x):                      # one shard skips its collective
        return x if t.shard_index() == 0 else t.psum(x)

    with pytest.raises(ShardFailure, match="different collectives"):
        t.run(early, (torch.zeros(N),), out_reps=True)


def test_axis_that_does_not_split_raises():
    t = _mesh()
    with pytest.raises(ValueError, match="does not split into 4 shards"):
        t.run(lambda a, b: a, (torch.zeros(8), torch.zeros(6)),
              out_reps=False)


def test_counters_count_once_per_body():
    t = _mesh()
    dest = torch.arange(N * 8, dtype=torch.int32) % N

    def body(d):
        plan = t.plan_route(d, cap=8)
        r = t.route({"d": d}, plan=plan)
        return t.exchange(r.valid)

    t.run(body, (dest,), out_reps=False)
    one = LocalTransport(device="cpu")
    one.plan_route(dest[:8], cap=8)
    assert t.plan_builds == 1
    assert t.stats()["route"]["calls"] == 1
    assert t.stats()["route"]["msgs"] == N
    assert t.stats()["exchange"]["calls"] == 1
    # outside run a verb counts as usual
    t.read(torch.zeros(4, dtype=torch.int32), torch.arange(2))
    assert t.stats()["read"]["calls"] == 1


def test_in_place_blocks_return_the_base_tensor():
    t = _mesh()
    words = torch.zeros(N * 5, dtype=torch.int32)
    other = torch.ones(N * 2)

    def body(w, o):
        w += t.shard_index() + 1       # in place on my block
        return w, o.clone()

    w, o = t.run(body, (words, other), out_reps=(False, False))
    assert w is words and w.data_ptr() == words.data_ptr()
    assert w.tolist() == [i // 5 + 1 for i in range(N * 5)]
    assert o is not other and torch.equal(o, other)


def test_many_shards_under_fast_switching():
    """More shards than cores and a short switch interval: every psum is
    exact and the counters count each call site once."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        n = 2 * (os.cpu_count() or 4)
        t = MeshTransport(n, device="cpu", timeout=60)
        x = torch.arange(n * 3, dtype=torch.int32)

        def body(xb):
            acc = xb
            for _ in range(20):
                acc = t.psum(acc) % 1000
            return acc

        got = t.run(body, (x,), out_reps=True)
        want = x.reshape(n, 3).to(torch.int64)
        for _ in range(20):
            want = want.sum(0, keepdim=True).expand(n, 3) % 1000
        assert torch.equal(got, want[0].to(torch.int32))
        assert t.stats()["psum"]["calls"] == 20
    finally:
        sys.setswitchinterval(old)


@pytest.mark.gpu
def test_kernels_count_every_launch_from_many_shards():
    """Runs on the card only: 16 shards launch the rank, the scatter and
    the CAS at once on one stream, under fast thread switching; every
    launch is counted and the result equals the plain path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import ops
    n, per = 16, 4096
    g = torch.Generator(device="cuda").manual_seed(0)
    recs = torch.randint(0, n * 64, (n * per,), generator=g, device="cuda",
                         dtype=torch.int32)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        outs = {}
        for impl in ("kernel", "plain"):
            t = MeshTransport(n, device="cuda", impl=impl)
            words = torch.zeros(n * 64, dtype=torch.int32, device="cuda")

            def body(w, r):
                dest = torch.div(r, 64, rounding_mode="floor")
                res = t.route({"r": r}, dest, cap=per)
                lrec = torch.where(res.valid > 0, res.fields["r"] % 64, -1)
                ok, w = t.cas(w, lrec, torch.zeros_like(lrec),
                              torch.ones_like(lrec))
                return w, t.exchange(ok.to(torch.int32))

            ops.reset_launch_counts()
            outs[impl] = t.run(body, (words, recs), out_reps=(False, False))
            counts = ops.launch_counts()
            want = n if impl == "kernel" else 0
            assert counts["radix_partition_rank"] == want
            assert counts["radix_partition_scatter"] == want
            assert counts["cas_lock"] == want
        for a, b in zip(outs["kernel"], outs["plain"]):
            assert torch.equal(a, b)
    finally:
        sys.setswitchinterval(old)
