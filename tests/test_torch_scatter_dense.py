"""The dense contract of the port's scatter kernel, on the CPU.

``radix_partition.scatter`` fills no buffer first: it writes each kept row
where the rank put it and zeros after each bucket's ``counts[d]`` kept
slots.  That is the wire buffer only if the rank's slots fill each
bucket's first ``counts[d]`` slots exactly once.  These tests hold the
plain rank to that over random inputs, the plain scatter (which takes the
same ``counts``) to the JAX router's wire buffer, and the route plan's
``counts`` to the rank's.  Every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fabric import router as jr
from repro_torch.fabric import router as tr
from repro_torch.kernels import ops, ref

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _dest(rng, A, n):
    """Mostly deliverable, some filtered below 0 and at or past n."""
    return rng.integers(-2, n + 2, (A,)).astype(np.int32)


@settings(max_examples=80, deadline=None)
@given(n=st.integers(1, 8), cap=st.integers(0, 12), A=st.integers(0, 90),
       w=st.integers(0, 5), seed=st.integers(0, 2 ** 32 - 1))
def test_rank_fills_each_bucket_prefix_once(n, cap, A, w, seed):
    rng = np.random.default_rng(seed)
    dest = _dest(rng, A, n)
    slot, keep, overflow, counts = (x.numpy() for x in
                                    ref.rank(_t(dest), n, cap))
    sizes = np.bincount(dest[(dest >= 0) & (dest < n)], minlength=n)
    np.testing.assert_array_equal(counts, np.minimum(sizes, cap))
    in_range = (slot >= 0) & (slot < n * cap)
    np.testing.assert_array_equal(in_range, keep)
    assert int(overflow.sum()) == int((sizes - counts).sum())
    for d in range(n):
        mine = np.sort(slot[keep & (dest == d)])
        np.testing.assert_array_equal(mine, d * cap + np.arange(counts[d]))
    # so the buffer is each kept, unmasked row in its slot and zeros
    # elsewhere, masked rows and every slot past counts[d] included
    rows = rng.integers(-2 ** 31, 2 ** 31, (A, w)).astype(np.int32)
    mask = rng.random(A) < 0.6
    buf = ref.scatter(_t(rows), _t(slot), n * cap, counts=_t(counts),
                      mask=_t(mask)).numpy()
    want = np.zeros((n * cap, w + 1), np.int32)
    sent = keep & mask
    want[slot[sent], :w] = rows[sent]
    want[slot[sent], w] = 1
    np.testing.assert_array_equal(buf, want)


def _fields(rng, A):
    np_f = {"rec": rng.integers(-5, 1000, (A,)).astype(np.int32),
            "word": rng.integers(0, 2 ** 32, (A, 2), dtype=np.uint32),
            "val": rng.standard_normal((A,)).astype(np.float32)}
    tf = {k: _t(v) for k, v in np_f.items()}
    tf["word"] = _t(np_f["word"].view(np.int32))
    return {k: jnp.asarray(v) for k, v in np_f.items()}, tf


@pytest.mark.parametrize("case", ["planless", "plan", "plan_mask"])
@pytest.mark.parametrize("n,cap", [(1, 64), (4, 6), (3, 2)])
def test_plain_scatter_with_counts_is_the_jax_wire_buffer(case, n, cap):
    rng = np.random.default_rng(n * 100 + cap)
    A = 48
    jf, tf = _fields(rng, A)
    dest = _dest(rng, A, n)
    mask = rng.random(A) < 0.6 if case == "plan_mask" else None
    wire = []

    def exchange(buf):
        wire.append(np.asarray(buf))
        return buf
    if case == "planless":
        jr.route(jf, jnp.asarray(dest), n=n, cap=cap, exchange=exchange,
                 backend="jnp")
    else:
        jr.route(jf, plan=jr.plan_route(jnp.asarray(dest), n=n, cap=cap),
                 mask=None if mask is None else jnp.asarray(mask),
                 exchange=exchange)
    rows, _, _ = tr.pack_fields(tf, valid=False)
    plan = tr.plan_route(_t(dest), n=n, cap=cap)
    buf = ref.scatter(rows, plan.slot, n * cap, counts=plan.counts,
                      mask=None if mask is None else _t(mask))
    np.testing.assert_array_equal(buf.numpy(), wire[0].view(np.int32))


@pytest.mark.parametrize("n,cap", [(1, 40), (1, 7), (3, 5), (8, 2)])
def test_route_plan_carries_the_rank_counts(n, cap):
    rng = np.random.default_rng(n * 10 + cap)
    dest = _dest(rng, 57, n)
    plan = tr.plan_route(_t(dest), n=n, cap=cap)
    assert plan.counts.dtype == torch.int32
    assert torch.equal(plan.counts, ref.rank(_t(dest), n, cap)[3])
    sizes = np.bincount(dest[(dest >= 0) & (dest < n)], minlength=n)
    np.testing.assert_array_equal(plan.counts.numpy(),
                                  np.minimum(sizes, cap))


def test_scatter_refuses_slots_that_are_not_buckets_times_cap():
    rows = torch.zeros((4, 2), dtype=torch.int32)
    slot = torch.arange(4, dtype=torch.int32)
    counts = torch.tensor([2, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="cap"):
        ref.scatter(rows, slot, 7, counts=counts)
    with pytest.raises(ValueError, match="cap"):
        ops.scatter_rows(rows, slot, 7, counts=counts)
    with pytest.raises(ValueError, match="cap"):
        ref.scatter(rows, slot, 4, counts=counts[:0])
    assert ops.scatter_rows(rows, slot, 4, counts=counts).shape == (4, 3)
