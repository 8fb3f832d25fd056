"""The port's NAM parameter server (``repro_torch.analytics``) against the
JAX package's: the ``ParameterServer`` tests of ``tests/test_analytics.py``
on the port, each also run on JAX's server with the same parameters and
gradients, whose server rows, epochs, returned views, residuals and
``fabric_stats()`` must be equal bit for bit; ``MeshTransport(4)`` equal
to ``LocalTransport``; and the route bytes of a push at mamba2-370m's
size equal to the JAX transport's count."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch

from repro.analytics import ParameterServer as JPS
from repro.analytics import sgd_apply as jsgd
from repro.fabric import LocalTransport as JLocal
from repro_torch.analytics import (DEFAULT_SHARDS, ParameterServer,
                                   row_layout, sgd_apply)
from repro_torch.fabric import LocalTransport, MeshTransport
from repro_torch.train import grad_compress as gc
from repro_torch.tree import ravel

SHAPES = {"w": (33, 9), "b": (11,)}
PARAMS = {"w": np.ones((33, 9), np.float32), "b": np.zeros((11,), np.float32)}


def _grad(i, scale=1.0):
    rng = np.random.default_rng(1000 + i)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _eq(t_tree, j_tree):
    for k in j_tree:
        np.testing.assert_array_equal(t_tree[k].numpy(),
                                      np.asarray(j_tree[k]), err_msg=k)


class Twin:
    """The port's server and JAX's on the same parameters; every push and
    pull runs on both and must agree."""

    def __init__(self, *, apply=None, **kw):
        self.j = JPS(_j(PARAMS), apply_fn=apply and apply[0], **kw)
        self.t = ParameterServer(_t(PARAMS), apply_fn=apply and apply[1],
                                 transport=LocalTransport(device="cpu"),
                                 **kw)

    def push(self, g, worker=0):
        e = self.t.push(_t(g), worker=worker)
        assert e == self.j.push(_j(g), worker=worker)
        return e

    def pull(self, worker=0):
        tv, te = self.t.pull(worker=worker)
        jv, je = self.j.pull(worker=worker)
        assert te == je
        _eq(tv, jv)
        return tv, te

    def check(self):
        np.testing.assert_array_equal(self.t._params.numpy(),
                                      np.asarray(self.j._params))
        assert self.t.epoch == self.j.epoch
        assert sorted(self.t._residuals) == sorted(self.j._residuals)
        for w, r in self.t._residuals.items():
            np.testing.assert_array_equal(r.numpy(),
                                          np.asarray(self.j._residuals[w]))
        assert self.t.fabric_stats() == self.j.fabric_stats()
        assert (self.t.num_shards, self.t.shard_len) == (
            self.j.num_shards, self.j.shard_len)
        assert self.t.wire_bytes_per_push() == self.j.wire_bytes_per_push()


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("k", [0, 2])
def test_pull_push_sequence_bit_equal(k, compress):
    """Pushes from two workers, pulls from three, at k in {0, 2}: every
    view, epoch, the rows, residuals and counters equal JAX's."""
    tw = Twin(staleness=k, block=64, compress=compress)
    for i in range(6):
        tw.push(_grad(i, 3.0), worker=i % 2)
        for w in range(3):
            tw.pull(worker=w)
    tw.check()


def test_pull_never_observes_epoch_older_than_bound():
    k = 3
    tw = Twin(staleness=k, block=64)
    for i in range(12):
        tw.push(_grad(i))
        _, epoch = tw.pull(worker=1)          # the lagging reader
        assert tw.t.epoch - k <= epoch <= tw.t.epoch
    tw.check()


def test_staleness_zero_is_always_fresh():
    tw = Twin(staleness=0, block=64)
    for i in range(5):
        tw.push(_grad(i))
        _, epoch = tw.pull(worker=1)
        assert epoch == tw.t.epoch == i + 1
    tw.check()


def test_stale_pulls_serve_the_cache_without_shard_reads():
    tw = Twin(staleness=5, block=64)
    ps = tw.t
    tw.pull(worker=1)                          # prime the cache
    shard_bytes = ps.num_shards * ps.shard_len * 4
    before = ps.fabric_stats()["read"]["bytes"]
    for i in range(3):
        tw.push(_grad(i))
        tw.pull(worker=1)
    assert ps.fabric_stats()["read"]["bytes"] - before < shard_bytes
    for i in range(3, 6):
        tw.push(_grad(i))                      # now 6 behind: must refresh
    _, epoch = tw.pull(worker=1)
    assert epoch == ps.epoch
    assert ps.fabric_stats()["read"]["bytes"] - before >= shard_bytes
    tw.check()


def test_stale_view_converges_after_refresh():
    tw = Twin(staleness=2, block=64, apply=(jsgd(lr=1.0), sgd_apply(lr=1.0)))
    stale_view, e0 = tw.pull(worker=1)
    stale_w = stale_view["w"].clone()
    tw.push(_grad(0))
    within, e1 = tw.pull(worker=1)
    assert e1 == e0
    assert torch.equal(within["w"], stale_w)
    for i in range(1, 4):
        tw.push(_grad(i))
    fresh, e2 = tw.pull(worker=1)              # 4 behind > k=2: refresh
    assert e2 == tw.t.epoch
    assert not torch.equal(fresh["w"], stale_w)
    assert torch.equal(fresh["w"], tw.t.current_params()["w"])
    tw.check()


def test_push_path_equals_grad_compress_roundtrip():
    """The gradient the server applies is bit for bit the grad_compress
    round trip of the pushed gradient, in both packages."""
    got = {"j": [], "t": []}

    def spy(key):
        def apply(params, grads):
            got[key].append(grads)
            return params
        return apply

    block = 64
    tw = Twin(staleness=0, block=block, apply=(spy("j"), spy("t")))
    ps = tw.t
    residual = torch.zeros((ps.num_shards, ps.shard_len))
    for i in range(4):
        g = _grad(i, scale=3.0)
        tw.push(g)
        flat = ravel(_t(g))[0]
        padded = torch.nn.functional.pad(
            flat, (0, ps.num_shards * ps.shard_len - flat.numel())
        ).reshape(ps.num_shards, ps.shard_len)
        codes, scale, residual = gc.compress_with_feedback(
            padded, residual, block=block)
        want = gc.decompress(codes, scale, padded.shape, block=block)
        assert torch.equal(ravel(got["t"][-1])[0],
                           want.reshape(-1)[:flat.numel()])
        _eq(got["t"][-1], got["j"][-1])
    tw.check()


def test_error_feedback_telescopes_through_push_path():
    applied = []
    tw = Twin(staleness=0, block=64,
              apply=(lambda p, g: p,
                     lambda p, g: (applied.append(g), p)[1]))
    total_true = torch.zeros(ravel(_t(PARAMS))[0].numel())
    for i in range(10):
        g = _grad(i)
        total_true += ravel(_t(g))[0]
        tw.push(g)
    total_applied = sum(ravel(g)[0] for g in applied)
    resid = tw.t._residuals[0].reshape(-1)[:total_true.numel()]
    np.testing.assert_allclose((total_applied + resid).numpy(),
                               total_true.numpy(), atol=1e-4)
    tw.check()


def test_push_pays_compressed_bytes_on_the_wire():
    comp = Twin(staleness=0, block=256)
    comp.push(_grad(0))
    raw = Twin(staleness=0, compress=False)
    raw.push(_grad(0))
    comp.check()
    raw.check()
    assert comp.t.fabric_stats()["route"]["bytes"] < \
        0.35 * raw.t.fabric_stats()["route"]["bytes"]
    c, r = comp.t.wire_bytes_per_push()
    assert c < 0.3 * r


def test_uncompressed_push_applies_exact_gradient():
    tw = Twin(staleness=0, compress=False,
              apply=(jsgd(lr=1.0), sgd_apply(lr=1.0)))
    g = _grad(0)
    tw.push(g)
    got = tw.t.current_params()
    np.testing.assert_allclose(got["w"].numpy(), PARAMS["w"] - g["w"],
                               atol=1e-6)
    tw.check()


def test_mesh4_equals_local():
    """MeshTransport(4): each shard routes its own rows to itself; rows,
    epoch, views and residuals equal the one-shard server's."""
    local = ParameterServer(_t(PARAMS), staleness=1, block=64,
                            transport=LocalTransport(device="cpu"))
    mesh = ParameterServer(_t(PARAMS), staleness=1, block=64,
                           transport=MeshTransport(4, device="cpu"))
    assert mesh.num_shards == local.num_shards == DEFAULT_SHARDS
    for i in range(5):
        assert local.push(_t(_grad(i))) == mesh.push(_t(_grad(i)))
        (lv, le), (mv, me) = local.pull(worker=1), mesh.pull(worker=1)
        assert le == me
        for k in SHAPES:
            assert torch.equal(lv[k], mv[k])
    assert torch.equal(local._params, mesh._params)
    assert torch.equal(local._residuals[0], mesh._residuals[0])
    # the mesh counts one route of n buckets a push
    assert mesh.fabric_stats()["route"]["msgs"] == 4 * 5


class _FakeWide(LocalTransport):
    @property
    def n(self):
        return 2


class _FakeTriple(LocalTransport):
    @property
    def n(self):
        return 3


def test_num_shards_must_divide_transport():
    with pytest.raises(ValueError):
        ParameterServer(_t(PARAMS), num_shards=3,
                        transport=_FakeWide(device="cpu"))


def test_default_num_shards_rounds_up_to_transport_multiple():
    ps = ParameterServer(_t(PARAMS), transport=_FakeTriple(device="cpu"))
    assert ps.num_shards == 6


def test_staleness_must_be_non_negative():
    with pytest.raises(ValueError):
        ParameterServer(_t(PARAMS), staleness=-1,
                        transport=LocalTransport(device="cpu"))


@pytest.mark.parametrize("n_values,block,num_shards", [
    (1, 256, None), (255, 32, None), (1000, 256, None), (4097, 32, None),
    (4097, 256, 2), (1000, 32, 8)])
def test_row_layout_equals_jax_servers(n_values, block, num_shards):
    """``row_layout`` (the (S, L) rows that phase ``train`` routes at
    mamba2's size without a server) is the JAX server's layout, and the
    port's server takes its own from it."""
    p = np.arange(n_values, dtype=np.float32)
    j = JPS({"p": jnp.asarray(p)}, block=block, num_shards=num_shards)
    t = ParameterServer({"p": torch.from_numpy(p)}, block=block,
                        num_shards=num_shards,
                        transport=LocalTransport(device="cpu"))
    want = (j.num_shards, j.shard_len)
    assert row_layout(n_values, block=block, num_shards=num_shards) == want
    assert (t.num_shards, t.shard_len) == want


@pytest.mark.parametrize("compress", [True, False])
def test_route_bytes_at_mamba2_size(compress):
    """``bench.train.route_bytes`` (what phase ``train`` holds every push
    to on the card) equals the JAX transport's count of one push's route
    at mamba2-370m's (S, L) with block 256, traced without data."""
    from repro_torch.bench import train as bt
    from repro_torch.configs import get_config
    from repro_torch.models import api
    n = sum(int(np.prod(s)) for s in _shape_leaves(
        api.param_shapes(get_config("mamba2-370m"))))
    S, L = row_layout(n)
    jt = JLocal()
    if compress:
        fields = {"codes": jax.ShapeDtypeStruct((S, L), jnp.int8),
                  "scale": jax.ShapeDtypeStruct((S, L // 256), jnp.float32)}
    else:
        fields = {"grad": jax.ShapeDtypeStruct((S, L), jnp.float32)}
    jax.eval_shape(lambda f: jt.route(f, jnp.zeros((S,), jnp.int32),
                                      cap=S).fields, fields)
    assert jt.stats()["route"]["bytes"] == bt.route_bytes(S, L, 256,
                                                          compress)
    assert (n, S, L) == (368_227_840, 4, 92_057_088)


def _shape_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _shape_leaves(v)
    else:
        yield tree
