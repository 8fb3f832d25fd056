"""The port's benchmark modules at a small size, on the CPU.

  * ``bench/fig6_rsi.py``: the fig6 commit batch counts and commits
    exactly what the JAX package's ``rsi.commit`` does on the same numpy
    workload, at the JAX benchmark's shape (every insert collides, so the
    whole batch aborts) and at the paper's shape (inserts on unborn rows);
  * ``bench/checkout.py``: the §4.3 checkout waves that ``chip_smoke.py``
    drives on the card keep the facade's invariants, and every committed
    write reads back (``tests/test_torch_db.py`` holds the same facade
    against the JAX package's);
  * ``bench/fig8a_joins.py`` and ``bench/fig8b_agg.py`` at a tiny N: every
    join and aggregation meets its independent ground truth and the plain
    path, and the JAX facade gives the same answers on the same relations.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import rsi as jrsi
from repro.db import Database as JaxDatabase
from repro.fabric import LocalTransport as JaxLocalTransport
from repro_torch._bits import np_u32
from repro_torch.bench import checkout, fig6_rsi, fig8a_joins, fig8b_agg
from repro_torch.core import rsi
from repro_torch.db import AGG_VARIANTS, JOIN_VARIANTS, Database

SMALL = {
    "jax_shape": {"num_records": 3000, "T": 32, "insert_base": 2700,
                  "insert_span": 270},
    "paper_shape": {**fig6_rsi.paper_width(32), "num_records": 2000 + 128,
                    "seeded": 2000, "products": 2000, "insert_base": 2000,
                    "payload_words": 16},
}


@pytest.mark.parametrize("shape", sorted(SMALL))
def test_fig6_commit_matches_jax(shape):
    kw = SMALL[shape]
    r = fig6_rsi.measured_local_txn_rate(iters=2, device="cpu", **kw)
    store, txns = fig6_rsi.workload(**kw)
    jtp = JaxLocalTransport()
    jok, _ = jrsi.commit({k: jnp.asarray(v) for k, v in store.items()},
                         jrsi.TxnBatch(**{k: jnp.asarray(v)
                                          for k, v in txns.items()}),
                         transport=jtp)
    assert r["committed"] == int(np.asarray(jok).sum())
    assert r["stats"] == jtp.stats()
    assert r["plan_builds"] == jtp.plan_builds == 1
    assert (r["committed"] == 0) == (shape == "jax_shape")
    assert r["T"] == 32 and len(r["times_s"]) == 2


def test_checkout_waves_keep_invariants_and_read_back():
    products, T, waves, m = 400, 24, 2, 4
    plan = checkout.plan(seed=3, waves=waves, T=T, products=products,
                         payload_words=m)
    # hot products in every 6th session, so waves abort and retry
    for prods, _, _ in plan:
        prods[::6, :2] = (0, 1)
    db = Database(device="cpu")
    t = checkout.create_table(db, products=products, waves=waves, T=T,
                              payload_words=m)
    assert t.schema.num_records == products + waves * T * 4
    masks, sessions, commit_s = checkout.drive(db, plan, max_retries=2)
    st = db.txn_stats
    assert st["retries"] > 0 and len(commit_s) == waves
    final_aborts = sum(int((~mk).sum()) for mk in masks)
    assert st["commits"] + final_aborts == waves * T
    assert st["commits"] + st["aborts"] == sum(s.attempts for s in sessions)
    assert db.table("products").locked_rows() == 0
    rb = checkout.check_readback(db, sessions, sample=16)
    assert rb["rows"] > waves * T * 4 and rb["own_cid_checked"] == 16
    # a write the store does not hold is caught
    s = next(s for s in sessions if s.committed)
    s._payload = [p + 1 for p in s._payload]
    with pytest.raises(AssertionError, match="read back"):
        checkout.check_readback(db, sessions, sample=0)


def test_bench_windows_wrap_each_commit_only():
    """``around=`` opens one window per commit (the fig6 warm-up included)
    and none around a restore or a session's build."""
    import contextlib
    opened = []

    @contextlib.contextmanager
    def window():
        opened.append(1)
        yield

    kw = SMALL["jax_shape"]
    r = fig6_rsi.measured_local_txn_rate(iters=3, device="cpu",
                                         around=window, **kw)
    assert len(opened) == 4 and len(r["times_s"]) == 3
    s = r["spread"]
    assert s["min"] <= s["q1"] <= s["median"] <= s["q3"] <= s["max"]
    assert s["median"] == r["median_s"] and s["iqr_over_median"] >= 0
    opened.clear()
    db = Database(device="cpu")
    checkout.create_table(db, products=100, waves=2, T=8, payload_words=2)
    plan = checkout.plan(seed=1, waves=2, T=8, products=100, payload_words=2)
    _, _, commit_s = checkout.drive(db, plan, around=window)
    assert len(opened) == 2 == len(commit_s)


@pytest.mark.parametrize("times,want", [
    ([2.0], {"min": 2.0, "q1": 2.0, "median": 2.0, "q3": 2.0, "max": 2.0,
             "iqr_over_median": 0.0}),
    ([1.0, 2.0, 3.0, 4.0, 5.0], {"min": 1.0, "median": 3.0, "max": 5.0}),
])
def test_spread(times, want):
    got = fig6_rsi.spread(times)
    assert {k: got[k] for k in want} == want
    assert got["q1"] <= got["median"] <= got["q3"]


def test_fig8a_joins_small_meets_ground_truth_and_jax():
    n = 2048
    r = fig8a_joins.run(n, device="cpu", warmup=0, timed=2,
                        plain_sels=(0.5,), profiles=("rdma_fdr4x", "ipoeth"))
    assert [row["sel"] for row in r["rows"]] == list(fig8a_joins.SELS)
    for row in r["rows"]:
        assert set(row["variants"]) == set(JOIN_VARIANTS)
        assert set(row["planner"]) == {"rdma_fdr4x", "ipoeth"}
        for v in row["variants"].values():
            assert v["value"] == row["truth"] and v["dropped"] == 0
            assert len(v["times_s"]) == 2 and v["peak_bytes"] is None
            assert v["stats"]["route"]["calls"] == 2
        assert ("plain_s" in row["variants"]["ghj"]) == (row["sel"] == 0.5)
    assert r["rows"][0]["truth"] < r["rows"][-1]["truth"]
    assert r["shuffle_route"]["rows"] == n
    assert r["modeled_wire_s"]["rdma_fdr4x"] > 0
    # the same relations through the JAX facade
    rk, rv, sk, sv = (np_u32(t) for t in fig8a_joins.relations(0.75, n,
                                                               device="cpu"))
    assert sorted(rk.tolist()) == list(range(1, n + 1))
    truth = int(np.where(sk <= n, sk.astype(np.int64), 0).sum()) % 2 ** 32
    assert truth == r["rows"][2]["truth"]
    jdb = JaxDatabase()
    jdb.load_table("R", jnp.asarray(rk), jnp.asarray(rv))
    jdb.load_table("S", jnp.asarray(sk), jnp.asarray(sv))
    q = jdb.scan("R").join(jdb.scan("S").filter(sel=0.75)).aggregate()
    assert int(jdb.execute(q, force_variant="rrj").value) == truth


def test_fig8b_agg_small_meets_ground_truth_and_jax():
    n = 4096
    groups = (1, 64, 4096)
    r = fig8b_agg.run(n, device="cpu", groups=groups, warmup=0, timed=1,
                      plain_groups=(64,))
    assert [row["groups"] for row in r["rows"]] == list(groups)
    for row in r["rows"]:
        assert set(row["schemes"]) == set(AGG_VARIANTS)
        assert ("plain_s" in row["schemes"]["dist_agg"]) == \
            (row["groups"] == 64)
    assert r["kernel_row"]["rows"] == n and r["kernel_row"]["slots"] == 2048
    keys, vals = (np_u32(t) for t in fig8b_agg.table(n, device="cpu"))
    assert vals.tolist() == [1] * n and keys.max() < 1 << 30
    jdb = JaxDatabase()
    jdb.load_table("T", jnp.asarray(keys), jnp.asarray(vals))
    got = fig8b_agg.ground_truth(fig8b_agg.table(n, device="cpu")[0], 64)
    want = jdb.execute(jdb.scan("T").aggregate(groups=64),
                       force_variant="rdma_agg").value
    np.testing.assert_array_equal(np_u32(got), np.asarray(want))
    np.testing.assert_array_equal(np_u32(got),
                                  np.bincount(keys % 64, minlength=64))
