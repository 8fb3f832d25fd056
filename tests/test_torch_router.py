"""The port's router and radix partitioner against the JAX package's.

Inputs are drawn with numpy from a seed and fed to both; every comparison
is exact (bit patterns).  On the CPU the port runs the plain versions of
its kernels; the JAX side runs ``radix_partition`` as
``tests/test_kernels.py`` does (interpret mode).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fabric import router as jr
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.fabric import router as tr
from repro_torch.kernels import ops, ref


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(x) -> np.ndarray:
    """Raw bytes of a JAX array or a torch tensor, for bit comparison."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        x = x.view(np.int16)
    return np.ascontiguousarray(x).view(np.uint8)


def _fields(rng, A, half_nan=True):
    """One leaf of every wire dtype: bool, u8, bf16, f32 with NaNs and
    infinities, i32 and u32 (an int32 bit view in the port).

    ``half_nan=False`` turns bf16 NaN patterns into infinities: XLA on the
    CPU canonicalizes bf16 NaNs (to 0x7FC0) when the JAX router slices
    the unpacked lanes, while the port keeps every bit, so a routed
    comparison with JAX only holds for non-NaN bf16."""
    bf = rng.integers(0, 2 ** 16, (A, 3), dtype=np.uint32).astype(np.uint16)
    if not half_nan:
        bf = np.where((bf & 0x7F80) == 0x7F80, bf & 0xFF80, bf)
    f32 = rng.standard_normal((A, 2)).astype(np.float32)
    f32[::3, 0] = np.nan
    f32[1::5, 1] = np.array([0x7FC01234], np.uint32).view(np.float32)[0]
    f32[2::7, 0] = np.inf
    np_f = {
        "flag": rng.random((A, 3)) < 0.5,
        "byte": rng.integers(0, 256, (A, 5), dtype=np.uint32).astype(
            np.uint8),
        "half": bf,
        "val": f32,
        "rec": rng.integers(-5, 1000, (A,)).astype(np.int32),
        "word": rng.integers(0, 2 ** 32, (A,), dtype=np.uint32),
    }
    jf = {k: jnp.asarray(v) for k, v in np_f.items()}
    jf["half"] = jax.lax.bitcast_convert_type(jnp.asarray(bf), jnp.bfloat16)
    tf = {k: _t(v) for k, v in np_f.items()}
    tf["half"] = _t(bf.view(np.int16)).view(torch.bfloat16)
    tf["word"] = _t(np_f["word"].view(np.int32))
    return jf, tf


def _assert_tree_bits(jtree, ttree):
    assert sorted(jtree) == sorted(ttree)
    for k in jtree:
        np.testing.assert_array_equal(_bits(ttree[k]), _bits(jtree[k]),
                                      err_msg=k)


@pytest.mark.parametrize("A", [0, 1, 37])
def test_pack_unpack_matches_jax_bits(A):
    rng = np.random.default_rng(A)
    jf, tf = _fields(rng, A)
    for valid in (True, False):
        jbuf, _, _ = jr.pack_fields(jf, valid=valid)
        tbuf, treedef, specs = tr.pack_fields(tf, valid=valid)
        assert tbuf.dtype == torch.int32
        np.testing.assert_array_equal(tbuf.numpy(),
                                      np.asarray(jbuf).view(np.int32))
    assert tr.packed_row_words(tf) == jr.packed_row_words(jf)
    back, valid = tr.unpack_fields(tr.pack_fields(tf)[0], treedef, specs)
    assert valid.dtype == torch.int32 and bool((valid == 1).all())
    for k in tf:
        assert back[k].dtype == tf[k].dtype
        np.testing.assert_array_equal(_bits(back[k]), _bits(tf[k]))


def test_pytree_order_and_nesting():
    x = {"b": (torch.arange(3), [torch.ones(3, 2)]), "a": torch.zeros(3)}
    leaves, td = tr.tree_flatten(x)
    assert [tuple(l.shape) for l in leaves] == [(3,), (3,), (3, 2)]
    y = tr.tree_unflatten(td, leaves)
    assert isinstance(y["b"], tuple) and isinstance(y["b"][1], list)
    assert torch.equal(y["b"][1][0], x["b"][1][0])


@pytest.mark.parametrize("n,cap", [(1, 40), (1, 7), (3, 5), (8, 2)])
def test_plan_route_and_bucket_ranks_match_jax(n, cap):
    rng = np.random.default_rng(n * 100 + cap)
    dest = rng.integers(-3, n + 3, (57,)).astype(np.int32)
    jp = jr.plan_route(jnp.asarray(dest), n=n, cap=cap, window=3)
    tp = tr.plan_route(_t(dest), n=n, cap=cap, window=3)
    for k in ("slot", "keep", "overflow"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                      np.asarray(getattr(jp, k)), err_msg=k)
    assert int(tp.dropped) == int(jp.dropped) and tp.window == 3
    np.testing.assert_array_equal(
        tr.bucket_ranks(_t(dest), n).numpy(),
        np.asarray(jr.bucket_ranks(jnp.asarray(dest), n)))


def _route_both(case, n, cap, A, seed):
    rng = np.random.default_rng(seed)
    jf, tf = _fields(rng, A, half_nan=False)
    dest = rng.integers(-2, n + 2, (A,)).astype(np.int32)
    mask = rng.random(A) < 0.6
    kw = {"chunks": 2 if case == "chunks" else 1}
    if case in ("plan_mask", "overlap_mask"):
        jkw = dict(kw, plan=jr.plan_route(jnp.asarray(dest), n=n, cap=cap),
                   mask=jnp.asarray(mask))
        tkw = dict(kw, plan=tr.plan_route(_t(dest), n=n, cap=cap),
                   mask=_t(mask))
        jres = jr.route(jf, overlap=case == "overlap_mask", **jkw)
        tres = tr.route(tf, overlap=case == "overlap_mask", **tkw)
    else:
        overlap = case == "overlap"
        jres = jr.route(jf, jnp.asarray(dest), n=n, cap=cap, overlap=overlap,
                        backend="jnp", **kw)
        tres = tr.route(tf, _t(dest), n=n, cap=cap, overlap=overlap, **kw)
    return jres, tres


ROUTE_CASES = ["planless", "plan_mask", "chunks", "overlap", "overlap_mask"]


@pytest.mark.parametrize("case", ROUTE_CASES)
@pytest.mark.parametrize("n,cap", [(1, 64), (4, 6), (3, 2)])
def test_route_matches_jax(case, n, cap):
    jres, tres = _route_both(case, n, cap, A=48,
                             seed=10 * ROUTE_CASES.index(case) + n)
    _assert_tree_bits(jres.fields, tres.fields)
    _assert_tree_bits(jres.sent, tres.sent)
    np.testing.assert_array_equal(tres.valid.numpy(), np.asarray(jres.valid))
    np.testing.assert_array_equal(tres.sent_valid.numpy(),
                                  np.asarray(jres.sent_valid))
    assert int(tres.dropped) == int(jres.dropped)


def test_route_negative_dest_filtered_not_wrapped():
    dest = _t(np.array([-1, 0, 1, 5, 0], np.int32))
    res = tr.route({"x": torch.arange(5, dtype=torch.int32)}, dest, n=2,
                   cap=2)
    assert int(res.dropped) == 0
    assert res.valid.tolist() == [1, 1, 1, 0]
    assert res.fields["x"].tolist() == [1, 4, 2, 0]


def test_route_overlap_with_exchange_matches_sync():
    """The chunked double-buffered path through an exchange gives the same
    bits as the synchronous scatter."""
    rng = np.random.default_rng(5)
    _, tf = _fields(rng, 40)
    dest = _t(rng.integers(-1, 3, (40,)).astype(np.int32))
    plan = tr.plan_route(dest, n=2, cap=8)
    seen = []

    def exchange(buf):
        seen.append(buf.shape[0])
        return buf.flip(0)
    sync = tr.route(tf, plan=plan, chunks=2, exchange=exchange)
    over = tr.route(tf, plan=plan, chunks=2, exchange=lambda b: b,
                    overlap=True)
    assert seen == [16]
    _assert_tree_bits(sync.sent, over.sent)
    assert torch.equal(sync.sent_valid, over.sent_valid)


def test_route_argument_errors():
    x = {"a": torch.zeros(4, dtype=torch.int32)}
    d = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        tr.route(x, d, n=1)
    with pytest.raises(ValueError):
        tr.route(x, d, n=1, cap=4, mask=torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError):
        tr.route(x, d, n=1, cap=3, chunks=2)
    with pytest.raises(ValueError):
        tr.route(x, d, n=1, cap=4, window=-1)


@pytest.mark.parametrize("fuse_valid", [False, True])
@pytest.mark.parametrize("nb,cap,D", [(1, 300, 3), (4, 64, 2), (8, 20, 5)])
def test_radix_partition_plain_matches_pallas_and_ref(fuse_valid, nb, cap,
                                                      D):
    rng = np.random.default_rng(nb * cap + D)
    N = 256
    vals = rng.integers(0, 2 ** 32, (N, D), dtype=np.uint32)
    bucket = rng.integers(0, nb, (N,)).astype(np.int32)
    out, counts = ref.radix_partition(_t(vals.view(np.int32)), _t(bucket),
                                      nb, cap, fuse_valid=fuse_valid)
    jout, jcounts = jops.radix_partition(jnp.asarray(vals),
                                         jnp.asarray(bucket), nb, cap,
                                         interpret=True,
                                         fuse_valid=fuse_valid)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jout).view(np.int32))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    if not fuse_valid:
        rout, rcounts = jref.radix_partition(jnp.asarray(vals),
                                             jnp.asarray(bucket), nb, cap)
        np.testing.assert_array_equal(out.numpy(),
                                      np.asarray(rout).view(np.int32))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(rcounts))


def test_radix_partition_ignores_out_of_range_buckets_like_pallas():
    rng = np.random.default_rng(3)
    vals = rng.standard_normal((256, 2)).astype(np.float32)
    bucket = rng.integers(-3, 7, (256,)).astype(np.int32)
    out, counts = ref.radix_partition(_t(vals), _t(bucket), 4, 30)
    jout, jcounts = jops.radix_partition(jnp.asarray(vals),
                                         jnp.asarray(bucket), 4, 30,
                                         interpret=True)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(_bits(out), _bits(jout))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))


def test_kernel_dispatch_rules():
    d = torch.zeros(4, dtype=torch.int32)
    assert ops.resolve_impl(d) == "plain"
    assert ops.resolve_impl(d, "plain") == "plain"
    with pytest.raises(ValueError):
        ops.resolve_impl(d, "kernel")
    with pytest.raises(ValueError):
        ops.resolve_impl(d, "pallas")
    before = ops.launch_counts()
    tr.route({"a": d}, d, n=1, cap=4)
    assert ops.launch_counts() == before     # the CPU launches no kernel


@pytest.mark.gpu
def test_kernels_match_plain_on_card():
    """Runs on the card only (``python3 chip_smoke.py`` sweeps far more)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    dest = torch.randint(-2, 10, (5000,), generator=g, device=dev,
                         dtype=torch.int32)
    rows = torch.randint(0, 1000, (5000, 5), generator=g, device=dev,
                         dtype=torch.int32)
    for got, want in zip(ops.rank(dest, 8, 500), ref.rank(dest, 8, 500)):
        assert torch.equal(got, want)
    slot = ops.rank(dest, 8, 500)[0]
    assert torch.equal(ops.scatter_rows(rows, slot, 4000),
                       ref.scatter(rows, slot, 4000))
    words = torch.randint(0, 3, (100,), generator=g, device=dev,
                          dtype=torch.int32)
    idx = torch.randint(-2, 103, (3000,), generator=g, device=dev,
                        dtype=torch.int32)
    exp = torch.randint(0, 3, (3000,), generator=g, device=dev,
                        dtype=torch.int32)
    prio = torch.randint(-4, 4, (3000,), generator=g, device=dev,
                         dtype=torch.int32)
    kw, pw = words.clone(), words.clone()
    ok_k = ops.cas(kw, idx, exp, exp + 7, prio)
    ok_p = ops.cas(pw, idx, exp, exp + 7, prio, impl="plain")
    assert torch.equal(ok_k, ok_p) and torch.equal(kw, pw)
