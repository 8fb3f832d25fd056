"""The port's planned queries against the JAX facade.

Both databases load the same relations (drawn once with numpy; the port
takes the JAX tables' ``scan_arrays()`` through ``Database.load_table``):

  * ``explain`` gives the same alternatives (names, ``chosen``, feasibility,
    ``cost_s`` to 1e-12 relative) and cost-model inputs over
    {rdma, ipoeth} x selectivity, and over group counts;
  * forced and planned ``execute`` give the same value, variant and
    counters (a fresh JAX database per query: its counters accumulate at
    trace time, on a shape's first execution only);
  * the validation errors, ``calibrate=True`` and ``Planner(load>0)``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.db import Database as JaxDatabase
from repro_torch._bits import np_u32
from repro_torch.db import AGG_VARIANTS, JOIN_VARIANTS, Database, Planner

SELS = (0.25, 0.5, 0.75, 1.0)


@pytest.fixture(scope="module")
def cols():
    rng = np.random.default_rng(0)
    rk = rng.permutation(np.arange(1, 2049, dtype=np.uint32))
    sk = rng.integers(1, 4096, 4096).astype(np.uint32)
    return {"R": (rk, rk * np.uint32(3)),
            "S": (sk, np.full(4096, 2, np.uint32))}


def _jax_db(cols, net="rdma"):
    db = JaxDatabase(net=net)
    for name, (k, v) in cols.items():
        db.load_table(name, jnp.asarray(k), jnp.asarray(v))
    return db


def _port_db(jdb, net="rdma"):
    """The port's database holding the JAX tables' scanned columns."""
    db = Database(device="cpu", net=net)
    for name, t in jdb.tables.items():
        db.load_table(name, *(np.asarray(a) for a in t.scan_arrays()))
    return db


def _join(db, sel):
    return db.scan("R").join(db.scan("S").filter(sel=sel)).aggregate()


def _same_alternatives(a, b):
    assert [(x.name, x.chosen, x.feasible) for x in a] == \
        [(x.name, x.chosen, x.feasible) for x in b]
    for x, y in zip(a, b):
        assert x.cost_s == pytest.approx(y.cost_s, rel=1e-12, abs=0)


@pytest.mark.parametrize("net", ["rdma", "ipoeth"])
def test_explain_matches_jax(cols, net):
    jdb = _jax_db(cols, net)
    db = _port_db(jdb, net)
    for sel in SELS:
        je, te = jdb.explain(_join(jdb, sel)), db.explain(_join(db, sel))
        _same_alternatives(te.alternatives, je.alternatives)
        assert te.inputs == je.inputs and te.kind == je.kind == "join_agg"
        assert te.plan == je.plan and te.chosen == je.chosen
    for g in (1, 64, 4096, 262_144):
        je = jdb.explain(jdb.scan("S").aggregate(groups=g))
        te = db.explain(db.scan("S").aggregate(groups=g))
        _same_alternatives(te.alternatives, je.alternatives)
        assert te.inputs == je.inputs
    # another point of the network axis, without touching db state
    je = jdb.explain(_join(jdb, 0.5), profile="rdma_edr")
    te = db.explain(_join(db, 0.5), profile="rdma_edr")
    _same_alternatives(te.alternatives, je.alternatives)
    assert db.planner.net == net


@pytest.mark.parametrize("variant", JOIN_VARIANTS + (None,))
def test_join_execute_matches_jax(cols, variant):
    jdb = _jax_db(cols)
    db = _port_db(jdb)
    jr = jdb.execute(_join(jdb, 0.5), force_variant=variant)
    tr = db.execute(_join(db, 0.5), force_variant=variant)
    assert tr.variant == jr.variant
    assert tr.planned == jr.planned
    assert int(np_u32(tr.value)) == int(jr.value)
    assert tr.stats == jr.stats and tr.dropped == 0
    # the port counts every execution (a jitted JAX shape only its first)
    again = db.execute(_join(db, 0.5), force_variant=variant)
    assert again.stats == tr.stats and jdb.execute(
        _join(jdb, 0.5), force_variant=variant).stats == {}


@pytest.mark.parametrize("variant", AGG_VARIANTS + (None,))
def test_group_execute_matches_jax(cols, variant):
    jdb = _jax_db(cols)
    db = _port_db(jdb)
    for g in (4, 64):
        jr = jdb.execute(jdb.scan("S").aggregate(groups=g),
                         force_variant=variant)
        tr = db.execute(db.scan("S").aggregate(groups=g),
                        force_variant=variant)
        assert tr.variant == jr.variant and tr.dropped is None
        np.testing.assert_array_equal(np_u32(tr.value), np.asarray(jr.value))
        assert tr.stats == jr.stats
        assert int(np_u32(tr.value).sum()) == 4096 * 2


def test_query_validation(cols):
    db = _port_db(_jax_db(cols))
    with pytest.raises(ValueError, match="not in"):
        db.execute(db.scan("R").join(db.scan("S")).aggregate(),
                   force_variant="nested_loop")
    with pytest.raises(ValueError, match="aggregate"):
        db.explain(db.scan("R"))
    with pytest.raises(ValueError, match="groups"):
        db.explain(db.scan("R").aggregate())     # bare scan aggregate
    with pytest.raises(KeyError):
        db.scan("missing")
    with pytest.raises(ValueError, match="sel"):
        db.scan("R").filter(sel=0.0)
    with pytest.raises(ValueError, match="scalar"):
        db.scan("R").join(db.scan("S")).aggregate(groups=64)


def test_execute_calibrate_installs_measured_rate():
    db = Database(device="cpu")
    db.load_table("R", np.arange(1, 513, dtype=np.uint32),
                  np.ones(512, np.uint32))
    db.load_table("S", np.arange(1, 1025, dtype=np.uint32),
                  np.ones(1024, np.uint32))
    q = db.scan("R").join(db.scan("S")).aggregate()
    assert db.planner.effective_net is db.planner.profile
    res = db.execute(q, calibrate=True)
    assert res.stats and int(res.value) == 512      # rv = sv = 1
    rate = db.planner.effective_net
    assert isinstance(rate, float) and rate > 0
    # later plans are priced with the measured wire rate
    ghj = {a.name: a.cost_s for a in db.explain(q).alternatives}["ghj"]
    fresh = Planner(net="rdma").join_alternatives(512 * 8, 1024 * 8)
    assert ghj != {a.name: a.cost_s for a in fresh}["ghj"]


def test_planning_under_load_is_not_ported(cols):
    """Planning under load, once missing from the port, now prices plans
    on the contention simulator's derated profile, as JAX does."""
    assert Planner(load=1).loaded_profile.name == "rdma_fdr4x+load1"
    jdb = _jax_db(cols)
    db = _port_db(jdb)
    for load in (0, 2):
        want = jdb.explain(_join(jdb, 0.5), load=load)
        got = db.explain(_join(db, 0.5), load=load)
        _same_alternatives(got.alternatives, want.alternatives)
        assert got.inputs["load"] == want.inputs["load"] == load
    assert Planner(load=0).load == 0


def test_load_numpy_scans_the_jax_relation(cols):
    jdb = _jax_db(cols)
    db = _port_db(jdb)
    for name in ("R", "S"):
        for a, b in zip(db.table(name).scan_arrays(),
                        jdb.table(name).scan_arrays()):
            np.testing.assert_array_equal(np_u32(a), np.asarray(b))
        assert db.table(name).stats() == jdb.table(name).stats()
    assert {"R/keys", "S/keys", "R/words"} <= set(db.pool.regions)
    with pytest.raises(TypeError, match="integer"):
        db.table("R").load(np.zeros(4, np.float32), np.zeros(4, np.uint32))
    with pytest.raises(TypeError, match="1-D"):
        db.table("R").load(np.zeros((2, 2), np.uint32),
                           np.zeros(4, np.uint32))
    with pytest.raises(ValueError, match="records"):
        db.table("R").load(np.zeros(4096, np.uint32),
                           np.zeros(4096, np.uint32))
    # a reload replaces the relation; u32 keys past 2**31 survive
    big = np.array([0xFFFFFFFE, 7], np.uint32)
    db.table("R").load(torch.tensor([-2, 7], dtype=torch.int32),
                       np.array([1, 2], np.uint32))
    k, v = db.table("R").scan_arrays()
    np.testing.assert_array_equal(np_u32(k), big)
    assert db.table("R").rows == 2 and np_u32(v).tolist() == [1, 2]
