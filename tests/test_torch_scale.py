"""fig_scale and fig10 in the port, and the Zipf workloads they draw,
held against the JAX package's benchmarks.

  * the port's numpy workload streams (``bench/workloads.py``) equal the
    JAX benchmark's, and keep its power law, flat uniform stream,
    distinct rows a transaction and disjoint home ranges;
  * fig_scale's economics (``txn_stats``, attempts, transaction ids, write
    sets) and its synthesized simulator traces equal the JAX benchmark's
    at W in {1, 4, 16} for all three skews (JAX eager,
    ``Database(jit=False)``); the retry economics keep their invariants;
  * fig10's panel rows equal the JAX benchmark's, and the join traces a
    ``Database`` records equal JAX's and replay to their anchors.
"""
import dataclasses as dc
import functools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

from benchmarks import fig10_contention as jfig10
from benchmarks import fig_scale as jfig_scale
from benchmarks import workloads as jworkloads
from repro.db import Database as JaxDatabase
from repro.fabric import sim as jsim
from repro_torch.bench import fig10_contention, fig_scale, workloads
from repro_torch.db import Database
from repro_torch.fabric import sim

SKEWS = sorted(fig_scale.SKEWS)
WORKERS = (1, 4, 16)


# ------------------------------------------------------------ workloads --

@pytest.mark.parametrize("s", [0.0, 0.9, 1.2])
def test_zipf_streams_equal_jax(s):
    np.testing.assert_array_equal(workloads.zipf_weights(500, s),
                                  jworkloads.zipf_weights(500, s))
    np.testing.assert_array_equal(
        workloads.zipf_keys(10_000, 777, s, seed=4, base=3),
        jworkloads.zipf_keys(10_000, 777, s, seed=4, base=3))
    for shared in (True, False):
        a = workloads.worker_write_sets(8, 5, 2, 4096, skew=s, seed=11,
                                        shared=shared)
        b = jworkloads.worker_write_sets(8, 5, 2, 4096, skew=s, seed=11,
                                         shared=shared)
        assert len(a) == len(b) == 8
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", range(4))
def test_weighted_sample_is_numpys_choice(seed):
    """The fast draw consumes the generator as ``rng.choice`` does and
    returns the same rows, collisions included (heavy skew, few rows)."""
    for n, k, s in ((9, 4, 2.0), (64, 5, 1.2), (1000, 2, 0.9), (7, 7, 1.0)):
        p = workloads.zipf_weights(n, s)
        cdf = np.cumsum(p)
        cdf /= cdf[-1]
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(50):
            np.testing.assert_array_equal(
                workloads.weighted_sample(a, p, cdf, k),
                b.choice(n, size=k, replace=False, p=p))
        assert a.random() == b.random()


def test_empirical_ranks_follow_target_skew():
    n, num, s = 64, 200_000, 1.2
    keys = workloads.zipf_keys(num, n, s, seed=5)
    obs = np.bincount(keys, minlength=n).astype(np.float64)
    exp = workloads.zipf_weights(n, s) * num
    assert float(np.sum((obs - exp) ** 2 / exp)) / (n - 1) < 2.0
    assert obs[0] == obs.max()
    assert all(obs[r] > obs[r + 1] for r in range(8))


def test_uniform_flat_and_write_sets_distinct_and_home_affine():
    obs = np.bincount(workloads.zipf_keys(100_000, 32, 0.0, seed=9),
                      minlength=32)
    assert obs.min() > 0.9 * obs.mean()
    for wsets in workloads.worker_write_sets(4, 8, 2, 256, skew=1.2,
                                             seed=3):
        assert wsets.shape == (8, 2)
        assert all(len(set(t.tolist())) == 2 for t in wsets)
    sets = workloads.worker_write_sets(4, 8, 2, 256, skew=1.2, seed=3,
                                       shared=False)
    for w, wsets in enumerate(sets):
        assert w * 64 <= wsets.min() and wsets.max() < (w + 1) * 64


def test_no_framework_in_the_generator():
    src = open(workloads.__file__).read()
    assert "import jax" not in src and "import torch" not in src


# ------------------------------------------------------- fig_scale (a,b) --

@functools.lru_cache(maxsize=None)
def _jax_econ(W, skew):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jfig_scale._run_economics(W, jfig_scale.SKEWS[skew])


@functools.lru_cache(maxsize=None)
def _port_econ(W, skew):
    return fig_scale.run_economics(W, fig_scale.SKEWS[skew], device="cpu")


@pytest.mark.parametrize("skew", SKEWS)
@pytest.mark.parametrize("W", WORKERS)
def test_economics_equal_jax(W, skew):
    js, jsets, jatt, jtids = _jax_econ(W, skew)
    ps, psets, patt, ptids = _port_econ(W, skew)
    assert ps == js
    assert patt == jatt and ptids == jtids
    for a, b in zip(psets, jsets):
        np.testing.assert_array_equal(a, b)
    # the accounting invariant: every attempt is a commit or an abort
    assert ps["commits"] + ps["aborts"] == sum(map(sum, patt))


@pytest.mark.parametrize("skew", SKEWS)
@pytest.mark.parametrize("W", WORKERS)
def test_synthesized_traces_equal_jax(W, skew):
    js, jsets, jatt, jtids = _jax_econ(W, skew)
    ps, psets, patt, ptids = _port_econ(W, skew)
    for loc in (True, False):
        place = fig_scale.assign_workers(W, W, locality=loc)
        ours = fig_scale.commit_trace(psets, patt, ptids, W, place)
        theirs = jfig_scale._commit_trace(jsets, jatt, jtids, W, place)
        assert [dc.astuple(e) for e in ours] == \
            [dc.astuple(e) for e in theirs]
    tput, res = fig_scale.throughput("rdma_edr", psets, patt, ptids,
                                     ps["commits"], shards=W,
                                     placement=place)
    jtput, jres = jfig_scale._throughput("rdma_edr", jsets, jatt, jtids,
                                         js["commits"], shards=W,
                                         placement=place)
    assert tput == jtput and res.timeline == jres.timeline


@pytest.mark.parametrize("words", [1, 16, 256])
def test_trace_carries_the_row_bytes(words):
    """A wide store's install WRITEs carry its whole row (payload and
    version word); every other event is the default trace's."""
    ps, psets, patt, ptids = _port_econ(16, "zipf12")
    place = fig_scale.assign_workers(16, 16, locality=True)
    base = fig_scale.commit_trace(psets, patt, ptids, 16, place)
    wide = fig_scale.commit_trace(psets, patt, ptids, 16, place,
                                  row_bytes=fig_scale.row_bytes(words))
    assert fig_scale.row_bytes(words) == 4 * words + 4
    assert len(base) == len(wide)
    writes = 0
    for a, b in zip(base, wide):
        if a.verb == "write":
            writes += 1
            assert a.nbytes == a.msgs * fig_scale.ROW_BYTES
            assert b.nbytes == b.msgs * fig_scale.row_bytes(words)
            assert dc.replace(b, nbytes=a.nbytes) == a
        else:
            assert a == b
    assert writes > 0


def test_economics_panel_asserts_and_rows_match_jax_rows():
    econ = {s: {W: _port_econ(W, s) for W in WORKERS} for s in SKEWS}
    rows = []
    fig_scale.economics_panel(econ, WORKERS, rows)
    want = [(f"fig_scale/econ_{s}_w{W}", 0.0,
             f"commits_{_jax_econ(W, s)[0]['commits']}_aborts_"
             f"{_jax_econ(W, s)[0]['aborts']}_retries_"
             f"{_jax_econ(W, s)[0]['retries']}")
            for s in SKEWS for W in WORKERS]
    assert rows == want


def test_fig_scale_run_panels_hold_on_the_cpu():
    rows, extras = fig_scale.run(("rdma_edr", "ethernet_1g"),
                                 workers=(4, 32),
                                 skews={"uniform": 0.0, "zipf12": 1.2},
                                 device="cpu")
    names = {r[0] for r in rows}
    assert {"fig_scale/rdma_edr_scaling", "fig_scale/econ_zipf12_w32",
            "fig_scale/rdma_edr_locality_on"} <= names
    assert extras["abort_rate"]["zipf12"]["32"] > \
        extras["abort_rate"]["uniform"]["32"]
    assert extras["locality"]["rdma_edr"]["on"]["local_fraction"] == 1.0


def test_real_size_knobs_keep_the_invariants():
    """The keyword sizes the card run uses, small: wide payloads, more
    transactions a worker; commits + final aborts == sessions, and every
    committed write reads back (the last writer's payload and cid)."""
    st, sets, att, tids, run = fig_scale.run_economics(
        4, 1.2, records=512, payload_words=8, txns_per_worker=16,
        device="cpu", keep=True)
    sessions = [s for g in run["groups"] for s in g]
    final_aborts = sum(int((~m).sum()) for m in run["masks"])
    assert st["commits"] + final_aborts == len(sessions) == 64
    assert st["retries"] > 0
    out = fig_scale.read_back(run["db"], sessions)
    assert out["rows"] > 0
    plain = fig_scale.run_economics(4, 1.2, records=512, payload_words=8,
                                    txns_per_worker=16, device="cpu",
                                    impl="plain", keep=True)
    assert plain[0] == st
    assert fig_scale.store_equal(run["db"], plain[4]["db"])


# ------------------------------------------------------------- fig10 ----

def test_fig10_rows_equal_jax():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jrows, jextras = jfig10.run()
    rows, extras = fig10_contention.run(device="cpu")
    assert rows == jrows
    assert extras["crossover"] == jextras["crossover"]
    assert extras["fabric"] == jextras["fabric"]


@pytest.mark.parametrize("variant", ["ghj", "rrj"])
def test_recorded_join_trace_equals_jax_and_replays(variant):
    n = 2048
    keys = np.arange(1, n + 1, dtype=np.uint32)
    sk = np.where(np.arange(n) % 4 == 0, keys, keys + n).astype(np.uint32)
    jdb = JaxDatabase(jit=False)
    jdb.load_table("R", jnp.asarray(keys), jnp.asarray(keys))
    jdb.load_table("S", jnp.asarray(sk), jnp.ones((n,), jnp.uint32))
    jq = jdb.scan("R").join(jdb.scan("S").filter(sel=0.25)).aggregate()
    jt = jsim.EventTracer()
    jdb.transport.tracer = jt
    jdb.execute(jq, force_variant=variant)
    db = Database(device="cpu")
    db.load_table("R", keys, keys)
    db.load_table("S", sk, np.ones((n,), np.uint32))
    trace, res = fig10_contention.record_join(
        db, fig10_contention.join_query(db), variant)
    assert res.variant == variant and res.dropped == 0
    assert [dc.astuple(e) for e in trace] == \
        [dc.astuple(e) for e in jt.events]
    assert db.transport.tracer is None
    rows = []
    info = fig10_contention.replay_rows(trace, ("rdma_edr", "ethernet_1g"),
                                        rows, variant)
    assert len(rows) == 2
    for p in info.values():
        assert p["lower_bound_s"] <= p["sim_s"] <= p["window1_s"]
