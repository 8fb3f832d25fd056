"""Fig 2 in the port (``repro_torch.bench.fig2_microbench``) against the
JAX benchmark (``benchmarks/fig2_microbench.py``):

  * the modeled rows (latency and bandwidth a message size and profile,
    Fig 3's cycles, Fig 4's message rates) are equal, value for value;
  * the measured rows come in the JAX benchmark's order, and under
    ``timed`` every one of them has its ``measured_s``;
  * the measured verbs give the JAX package's answers on the same numpy
    inputs: READ (``fabric.read``), CAS and FETCH_ADD (``fabric.cas``,
    ``fabric.fetch_add``: flags, fetched values and words) and the 64K
    route (``LocalTransport.route``), at the figure's shapes and with
    conflicting requests.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import fig2_microbench as jfig2
from repro import fabric as jfabric
from repro_torch._bits import np_to_i32, np_u32
from repro_torch.bench import fig2_microbench as fig2
from repro_torch.fabric import LocalTransport, verbs


@pytest.fixture(scope="module")
def jax_run():
    return jfig2.run()


def test_modeled_rows_equal_jax(jax_run):
    jrows, jextras = jax_run
    want = [r for r in jrows if "/model_" in r[0]]
    assert fig2.modeled_rows(fig2.DEFAULT_PROFILES) == want
    assert fig2.modeled_rows(("rdma_edr",)) == \
        [r for r in want if "rdma_edr" in r[0]]


def test_measured_rows_in_jax_order(jax_run):
    rows, extras = fig2.run(timed=True, device="cpu")
    jrows, jextras = jax_run
    assert [r[0] for r in rows] == [r[0] for r in jrows]
    assert rows[len(extras["measured_s"]):] == \
        [r for r in jrows if "/model_" in r[0]]
    assert list(extras["measured_s"]) == \
        [r[0] for r in rows if "/model_" not in r[0]]
    assert extras["profiles"] == jextras["profiles"]
    assert all(us > 0 for _, us, _ in rows[:7])


def _t(a):
    return torch.from_numpy(np_to_i32(a))


@pytest.mark.parametrize("conflicts", [False, True])
def test_verbs_equal_jax_on_the_same_inputs(conflicts):
    rng = np.random.default_rng(5 + conflicts)
    R, A = fig2.REGION_ROWS, fig2.REQS
    region = rng.standard_normal((R, fig2.REGION_WIDTH)).astype(np.float32)
    words = rng.integers(0, 1 << 32, R, dtype=np.uint64).astype(np.uint32)
    idx = (rng.integers(0, 64, A) if conflicts
           else np.arange(A)).astype(np.int32)
    expected = np.where(rng.random(A) < 0.5, words[idx],
                        rng.integers(0, 1 << 32, A, dtype=np.uint64)
                        ).astype(np.uint32)
    new = rng.integers(0, 1 << 32, A, dtype=np.uint64).astype(np.uint32)
    delta = rng.integers(0, 1 << 32, A, dtype=np.uint64).astype(np.uint32)

    got = verbs.read(torch.from_numpy(region), torch.from_numpy(idx))
    want = jfabric.read(jnp.asarray(region), jnp.asarray(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    w = _t(words)
    ok, w = verbs.cas(w, torch.from_numpy(idx), _t(expected), _t(new))
    jok, jw = jfabric.cas(jnp.asarray(words), jnp.asarray(idx),
                          jnp.asarray(expected), jnp.asarray(new))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(np_u32(w), np.asarray(jw))
    assert conflicts or ok.any()

    w = _t(words)
    fetched, w = verbs.fetch_add(w, torch.from_numpy(idx), _t(delta))
    jf, jw = jfabric.fetch_add(jnp.asarray(words), jnp.asarray(idx),
                               jnp.asarray(delta))
    np.testing.assert_array_equal(np_u32(fetched), np.asarray(jf))
    np.testing.assert_array_equal(np_u32(w), np.asarray(jw))


@pytest.mark.parametrize("keys", ["arange", "random"])
def test_route_64k_equals_jax(keys):
    ks = (np.arange(fig2.ROUTE_REQS) if keys == "arange" else
          np.random.default_rng(3).integers(0, 1 << 32, fig2.ROUTE_REQS,
                                            dtype=np.uint64)
          ).astype(np.uint32)
    got = fig2.route_64k(LocalTransport(device="cpu"), _t(ks))
    jtp = jfabric.LocalTransport()
    k = jnp.asarray(ks)
    want = jtp.route({"k": k, "v": k}, (k % jnp.uint32(1)).astype(jnp.int32),
                     cap=fig2.ROUTE_REQS).fields["k"]
    np.testing.assert_array_equal(np_u32(got), np.asarray(want))
