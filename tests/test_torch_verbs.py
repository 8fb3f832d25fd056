"""The port's one-sided verbs and transport counters against the JAX
package's.

Inputs are drawn with numpy from a seed and fed to both; 32-bit words are
u32 arrays on the JAX side and int32 bit views in the port, and every
comparison is exact (bit patterns and counters).  On the CPU the port runs
the plain version of its CAS kernel.  The Pallas ``cas_lock`` does not run
under this JAX, so the CAS is held against ``repro.fabric.verbs.cas`` and
against the sequential ``cas_lock`` references of both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fabric import LocalTransport as JaxLocalTransport
from repro.fabric import verbs as jv
from repro.kernels import ref as jref
from repro_torch._bits import LOCK_BIT, np_to_i32, np_u32
from repro_torch.fabric import LocalTransport
from repro_torch.fabric import router as tr
from repro_torch.fabric import verbs as tv
from repro_torch.kernels import ops, ref


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _w(a):
    """numpy u32 -> the port's int32 bit-view tensor."""
    return _t(np_to_i32(a))


def _u32(rng, shape, high=2 ** 32):
    return rng.integers(0, high, shape, dtype=np.uint64).astype(np.uint32)


def _priority(rng, kind, A):
    if kind == "default":
        return None
    if kind == "ties":
        return rng.integers(0, 3, A).astype(np.int32)
    if kind == "negative":
        return rng.integers(-4, 4, A).astype(np.int32)
    return rng.integers(-2 ** 31, 2 ** 31 - 1, A, dtype=np.int64).astype(
        np.int32)


PRIORITIES = ["default", "ties", "negative", "wide"]


# ------------------------------------------------------------------ CAS --

@pytest.mark.parametrize("prio_kind", PRIORITIES)
@pytest.mark.parametrize("R,A", [(1, 9), (16, 40), (50, 200)])
def test_cas_matches_jax(R, A, prio_kind):
    """Repeats, ties, negative priorities, idx < 0 and idx >= R (the JAX
    gather clamps, its scatter drops)."""
    rng = np.random.default_rng(R * 1000 + A + PRIORITIES.index(prio_kind))
    words = rng.integers(0, 4, R).astype(np.uint32)
    words[rng.random(R) < 0.2] |= np.uint32(1 << 31)
    idx = rng.integers(-2, R + 3, A).astype(np.int32)
    exp = np.where(rng.random(A) < 0.7, words[np.clip(idx, 0, R - 1)],
                   rng.integers(0, 4, A)).astype(np.uint32)
    new = _u32(rng, A)
    prio = _priority(rng, prio_kind, A)
    jok, jw = jv.cas(jnp.asarray(words), jnp.asarray(idx), jnp.asarray(exp),
                     jnp.asarray(new),
                     priority=None if prio is None else jnp.asarray(prio))
    tw = _w(words)
    ok, out = tv.cas(tw, _t(idx), _w(exp), _w(new),
                     priority=None if prio is None else _t(prio))
    assert out is tw                          # updated in place
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(np_u32(out), np.asarray(jw))


@pytest.mark.parametrize("seed", range(4))
def test_cas_plain_in_cas_lock_case_matches_fifo_refs(seed):
    """priority = arrival, new = expected | LOCK, unlocked expected words
    and no request at idx == R: the one-pass arbitration equals the
    sequential FIFO of the Pallas kernel's reference (both packages'
    ``ref.cas_lock``).  At idx == R the verb compares against the clamped
    last word and may let the request win the spare slot, where the FIFO
    fails it; ``test_cas_idx_at_end_wins_spare_slot_like_jax`` pins that."""
    rng = np.random.default_rng(seed)
    R, A = 24, 64
    words = rng.integers(0, 3, R).astype(np.uint32)
    words[rng.random(R) < 0.25] |= np.uint32(1 << 31)
    idx = rng.integers(-2, R + 2, A).astype(np.int32)
    idx[idx == R] = R + 1
    exp = rng.integers(0, 3, A).astype(np.uint32)
    jok, jw = jref.cas_lock(jnp.asarray(words), jnp.asarray(idx),
                            jnp.asarray(exp))
    fok, fw = ref.cas_lock(_w(words), _t(idx), _w(exp))
    np.testing.assert_array_equal(fok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(np_u32(fw), np.asarray(jw))
    tw = _w(words)
    ok = ops.cas(tw, _t(idx), _w(exp), _w(exp) | LOCK_BIT,
                 torch.arange(A, dtype=torch.int32))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(np_u32(tw), np.asarray(jw))


def test_cas_idx_at_end_wins_spare_slot_like_jax():
    """A request at idx == R whose expected equals the last word, first in
    line: ``verbs.cas`` reports it granted (and writes nothing); the FIFO
    ``cas_lock`` fails it.  The port follows the verb."""
    words = np.array([5, 7], np.uint32)
    idx = np.array([2, 1, 3], np.int32)
    exp = np.array([7, 7, 7], np.uint32)
    new = exp | np.uint32(1 << 31)
    jok, jw = jv.cas(jnp.asarray(words), jnp.asarray(idx), jnp.asarray(exp),
                     jnp.asarray(new))
    tw = _w(words)
    ok, _ = tv.cas(tw, _t(idx), _w(exp), _w(new))
    assert np.asarray(jok).tolist() == ok.tolist() == [True, True, False]
    np.testing.assert_array_equal(np_u32(tw), np.asarray(jw))
    fok, _ = ref.cas_lock(_w(words), _t(idx), _w(exp))
    assert fok.tolist() == [False, True, False]


def test_cas_rejects_non_word_tensor():
    with pytest.raises(TypeError):
        tv.cas(torch.zeros(4, dtype=torch.int64), torch.zeros(1, dtype=torch.int32),
               torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.int32))


# ------------------------------------------------------------ FETCH_ADD --

@pytest.mark.parametrize("prio_kind", PRIORITIES)
@pytest.mark.parametrize("R,A", [(1, 5), (8, 30), (40, 120)])
def test_fetch_add_matches_jax(R, A, prio_kind):
    """Exact (priority, arrival) exclusive prefix with u32 wrap; negative
    idx fetches 0, idx >= R fetches the last word and adds nothing."""
    rng = np.random.default_rng(7 * R + A + PRIORITIES.index(prio_kind))
    words = _u32(rng, R)
    words[: R // 2] = np.uint32(0xFFFFFFF0)             # near the wrap
    idx = rng.integers(-2, R + 2, A).astype(np.int32)
    delta = _u32(rng, A, 64)
    delta[::5] = np.uint32(0xFFFFFFFF)
    prio = _priority(rng, prio_kind, A)
    jf, jw = jv.fetch_add(jnp.asarray(words), jnp.asarray(idx),
                          jnp.asarray(delta),
                          priority=None if prio is None else jnp.asarray(prio))
    tw = _w(words)
    f, out = tv.fetch_add(tw, _t(idx), _w(delta),
                          priority=None if prio is None else _t(prio))
    assert out is tw
    np.testing.assert_array_equal(np_u32(f), np.asarray(jf))
    np.testing.assert_array_equal(np_u32(out), np.asarray(jw))


# ---------------------------------------------------------- READ / WRITE --

def test_read_out_of_range_matches_jax():
    """Negative rows read zeros; rows past the end read JAX ``take``'s
    fill: 0xFFFFFFFF for u32 words, NaN for floats."""
    rng = np.random.default_rng(3)
    R = 6
    idx = np.array([[0, 5, -1], [6, 40, -7]], np.int32)
    words = _u32(rng, (R, 3))
    jout = jv.read(jnp.asarray(words), jnp.asarray(idx))
    out = tv.read(_w(words), _t(idx))
    assert out.shape == (2, 3, 3)
    np.testing.assert_array_equal(np_u32(out), np.asarray(jout))
    vals = rng.standard_normal(R).astype(np.float32)
    jout = jv.read(jnp.asarray(vals), jnp.asarray(idx))
    out = tv.read(_t(vals), _t(idx))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert np.isnan(out.numpy()[1, :2]).all()


def test_write_drops_out_of_range_like_jax():
    rng = np.random.default_rng(4)
    R = 10
    region = _u32(rng, (R, 2))
    idx = np.array([3, -1, 10, 0, 25, 9], np.int32)
    vals = _u32(rng, (6, 2))
    jout = jv.write(jnp.asarray(region), jnp.asarray(idx), jnp.asarray(vals))
    tregion = _w(region)
    out = tv.write(tregion, _t(idx), _w(vals))
    assert out is tregion
    np.testing.assert_array_equal(np_u32(out), np.asarray(jout))


# -------------------------------------------------------------- counters --

def _verb_calls(rng):
    """One call of each verb, as (name, jax args, port args) thunks."""
    R, A = 12, 20
    words = rng.integers(0, 3, R).astype(np.uint32)
    region = _u32(rng, (R, 5))
    idx = rng.integers(-1, R, A).astype(np.int32)
    exp = rng.integers(0, 3, A).astype(np.uint32)
    new = exp | np.uint32(1 << 31)
    prio = rng.integers(0, 4, A).astype(np.int32)
    vals = _u32(rng, (A, 5))
    delta = np.ones(A, np.uint32)
    flags = rng.random((A, 3)) < 0.5
    dest = rng.integers(-1, 2, A).astype(np.int32)
    j = jnp.asarray
    return [
        ("read", lambda tp: tp.read(j(region), j(idx)),
         lambda tp: tp.read(_w(region), _t(idx))),
        ("read_async", lambda tp: tp.read_async(j(region), j(idx)).wait(),
         lambda tp: tp.read_async(_w(region), _t(idx)).wait()),
        ("write", lambda tp: tp.write(j(region), j(idx), j(vals)),
         lambda tp: tp.write(_w(region), _t(idx), _w(vals))),
        ("write_async",
         lambda tp: tp.write_async(j(region), j(idx), j(vals)).wait(),
         lambda tp: tp.write_async(_w(region), _t(idx), _w(vals)).wait()),
        ("cas", lambda tp: tp.cas(j(words), j(idx), j(exp), j(new),
                                  priority=j(prio)),
         lambda tp: tp.cas(_w(words), _t(idx), _w(exp), _w(new),
                           priority=_t(prio))),
        ("fetch_add", lambda tp: tp.fetch_add(j(words), j(idx), j(delta)),
         lambda tp: tp.fetch_add(_w(words), _t(idx), _w(delta))),
        ("route", lambda tp: tp.route({"r": j(idx), "v": j(vals),
                                       "f": j(flags)}, j(dest), cap=A,
                                      chunks=2, window=3),
         lambda tp: tp.route({"r": _t(idx), "v": _w(vals), "f": _t(flags)},
                             _t(dest), cap=A, chunks=2, window=3)),
        ("route_async", lambda tp: tp.route_async(
            {"r": j(idx)}, plan=tp.plan_route(j(dest), cap=A, window=2),
            mask=j(flags[:, 0])).wait(),
         lambda tp: tp.route_async(
            {"r": _t(idx)}, plan=tp.plan_route(_t(dest), cap=A, window=2),
            mask=_t(flags[:, 0])).wait()),
        ("collectives", lambda tp: (tp.exchange(j(vals), 2), tp.psum(j(exp)),
                                    tp.all_gather(j(flags))),
         lambda tp: (tp.exchange(_w(vals), 2), tp.psum(_w(exp)),
                     tp.all_gather(_t(flags)))),
        ("count_local", lambda tp: tp.count_local("read_hot", 7, 64,
                                                  window=2),
         lambda tp: tp.count_local("read_hot", 7, 64, window=2)),
    ]


@pytest.mark.parametrize("profile", [None, "rdma_edr", "ethernet_1g"])
def test_transport_counters_of_one_call_match_jax(profile):
    """Each verb once on fresh transports: calls, msgs, bytes,
    peak_outstanding, queue_hist, modeled_s and plan_builds equal."""
    rng = np.random.default_rng(11)
    for name, jcall, tcall in _verb_calls(rng):
        jtp = JaxLocalTransport(profile=profile)
        ttp = LocalTransport(profile=profile, device="cpu")
        jcall(jtp)
        tcall(ttp)
        assert ttp.stats() == jtp.stats(), name
        assert ttp.plan_builds == jtp.plan_builds, name
        if profile is not None:
            assert ttp.modeled_time() == jtp.modeled_time(), name
            assert ttp.modeled_time("rdma_fdr4x") == \
                jtp.modeled_time("rdma_fdr4x"), name


def test_transport_route_counts_packed_wire_like_jax():
    """A route bills the packed buffer: n*cap rows of packed_row_words
    lanes, whatever the leaf dtypes."""
    rng = np.random.default_rng(2)
    A = 10
    fields = {"b": _t(rng.random((A, 5)) < 0.5),
              "h": _t(rng.standard_normal((A, 3)).astype(np.float32)).to(
                  torch.bfloat16),
              "w": _w(_u32(rng, (A, 2)))}
    tp = LocalTransport(device="cpu")
    tp.route(fields, torch.zeros(A, dtype=torch.int32), cap=16)
    assert tp.stats()["route"]["bytes"] == 16 * 4 * tr.packed_row_words(
        fields) == 16 * 4 * (2 + 2 + 2 + 1)
    tp.reset_stats()
    assert tp.stats() == {} and tp.plan_builds == 0
    with pytest.raises(ValueError, match="profile"):
        tp.modeled_time()
