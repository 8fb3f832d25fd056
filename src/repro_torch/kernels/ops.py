"""Dispatch between each kernel and its plain version.

``impl=None`` picks by where the tensor lies: the hand-written kernel for
a CUDA tensor, the plain version (:mod:`repro_torch.kernels.ref`) for a
CPU tensor.  ``impl="kernel"`` on a CPU tensor raises.  ``impl="plain"``
runs the plain version on any device; it exists for the tests and for
``chip_smoke.py``'s comparison, never as a fallback: a kernel that fails
to build or launch raises.

Gradients.  The plain versions are differentiable torch code.  The
wrappers of ``flash_attention`` and ``ssd_scan`` return tensors with no
``grad_fn``, so when autograd needs one, the kernel runs inside an
``autograd.Function`` (:class:`FlashAttentionFn`, :class:`SSDScanFn`)
whose backward recomputes a plain function given by the caller
(``backward=``) on the saved inputs and returns its autograd gradient.
The JAX package has no backward kernel either: it trains through its
plain chunked functions, which are what the models pass here, and which
the plain path runs under autograd in place of the plain twins.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cas_lock as _cas
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import grouped_agg as _ga
from repro_torch.kernels import radix_partition as _rp
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd

IMPLS = ("kernel", "plain")


def resolve_impl(t: torch.Tensor, impl=None) -> str:
    if impl is None:
        return "kernel" if t.is_cuda else "plain"
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if impl == "kernel" and not t.is_cuda:
        raise ValueError(f"impl='kernel' needs a CUDA tensor, got {t.device}")
    return impl


def launch_counts() -> dict:
    """Launches of each kernel entry point since the last reset."""
    return {"radix_partition_rank": _rp.launches["rank"],
            "radix_partition_scatter": _rp.launches["scatter"],
            "cas_lock": _cas.launches["cas"],
            "grouped_agg": _ga.launches["f32"],
            "grouped_sum_u32": _ga.launches["u32"],
            "flash_attention": _fa.launches["flash"],
            "ssd_scan": _ssd.launches["ssd"]}


def reset_launch_counts():
    _rp.launches.update(rank=0, scatter=0)
    _cas.launches.update(cas=0)
    _ga.launches.update(f32=0, u32=0)
    _fa.launches.update(flash=0)
    _ssd.launches.update(ssd=0)


def rank(dest, n: int, cap: int, *, impl=None):
    """(slot, keep, overflow, counts) of ``dest`` into n buckets of cap."""
    dest = dest.to(torch.int32).contiguous()
    if resolve_impl(dest, impl) == "kernel":
        return _rp.rank(dest, n, cap)
    return ref.rank(dest, n, cap)


def scatter_rows(rows, slot, num_slots: int, *, counts, mask=None,
                 impl=None):
    """int32 ``rows`` into the (num_slots, w + 1) wire buffer, the valid
    lane appended; ``slot`` and ``counts`` are :func:`rank`'s."""
    rows = rows.contiguous()
    slot = slot.to(torch.int32).contiguous()
    if mask is not None:
        mask = mask.to(torch.bool).contiguous()
    if resolve_impl(rows, impl) == "kernel":
        return _rp.scatter(rows, slot, num_slots, counts=counts, mask=mask)
    return ref.scatter(rows, slot, num_slots, counts=counts, mask=mask)


def cas(words, idx, expected, new, priority, *, impl=None):
    """``repro.fabric.verbs.cas`` arbitration; updates ``words`` in place
    and returns ok (A,) bool."""
    if words.dtype != torch.int32 or not words.is_contiguous():
        raise TypeError("cas words must be a contiguous int32 tensor (u32 "
                        f"bit patterns), got {words.dtype}")
    args = [t.to(torch.int32).contiguous()
            for t in (idx, expected, new, priority)]
    if resolve_impl(words, impl) == "kernel":
        return _cas.cas(words, *args)
    return ref.cas(words, *args)


def grouped_agg(slot, vals, num_slots: int, *, impl=None,
                check: bool = False):
    """(num_slots,) f32 per-slot sums of ``vals`` by ``slot`` (the Pallas
    ``grouped_agg``'s function).  ``check=True`` makes the plain version
    raise on a slot outside [0, num_slots); the kernel skips such rows."""
    slot = slot.to(torch.int32).contiguous()
    vals = vals.to(torch.float32).contiguous()
    if resolve_impl(slot, impl) == "kernel":
        return _ga.grouped_agg(slot, vals, num_slots)
    return ref.grouped_agg(slot, vals, num_slots, check=check)


def grouped_sum_u32(slot, vals, num_slots: int, *, impl=None,
                    check: bool = False):
    """(num_slots,) u32 per-slot sums mod 2**32 of the u32 words ``vals``
    (int32 bit patterns) by ``slot``; ``check=`` as in :func:`grouped_agg`."""
    if vals.dtype != torch.int32:
        raise TypeError(f"grouped_sum_u32 takes u32 words as int32 bit "
                        f"patterns, got {vals.dtype}")
    slot = slot.to(torch.int32).contiguous()
    vals = vals.contiguous()
    if resolve_impl(slot, impl) == "kernel":
        return _ga.grouped_sum_u32(slot, vals, num_slots)
    return ref.grouped_sum_u32(slot, vals, num_slots, check=check)


def grouped_sum_u32_by_key(keys, vals, groups: int, *, chunks: int = 1,
                           n: int = 1, impl=None):
    """u32 sums mod 2**32 of the u32 words ``vals`` by a slot computed
    from the u32 ``keys`` (int32 bit patterns): ``key % groups``, or with
    ``chunks``/``n`` RDMA-AGG's phase-1 (chunk, owner, group) layout
    (``grouped_agg.grouped_sum_u32_by_key``)."""
    for name, t in (("keys", keys), ("vals", vals)):
        if t.dtype != torch.int32:
            raise TypeError(f"grouped_sum_u32_by_key takes u32 {name} as "
                            f"int32 bit patterns, got {t.dtype}")
    keys, vals = keys.contiguous(), vals.contiguous()
    if resolve_impl(keys, impl) == "kernel":
        return _ga.grouped_sum_u32_by_key(keys, vals, groups, chunks=chunks,
                                          n=n)
    return ref.grouped_sum_u32_by_key(keys, vals, groups, chunks=chunks,
                                      n=n)


# the profiler's label of a backward's plain recompute
PLAIN_BACKWARD = "ops.plain_backward"


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _plain_grads(ctx, fn, inputs, grads_out):
    """The gradients of ``fn(*inputs)`` (a tensor or a tuple whose first
    ``len(grads_out)`` entries carry gradient) for the inputs that need
    one, recomputed under autograd on detached copies of the inputs."""
    need = ctx.needs_input_grad[:len(inputs)]
    xs = [None if x is None else x.detach().requires_grad_(bool(w))
          for x, w in zip(inputs, need)]
    with torch.profiler.record_function(PLAIN_BACKWARD), \
            torch.enable_grad():
        out = fn(*xs)
        outs = (out,) if isinstance(out, torch.Tensor) else tuple(out)
        wrt = [x for x, w in zip(xs, need) if w and x is not None]
        got = iter(torch.autograd.grad(outs[:len(grads_out)], wrt,
                                       grads_out, allow_unused=True)
                   ) if wrt else iter(())
    return [next(got) if w and x is not None else None
            for x, w in zip(xs, need)]


class FlashAttentionFn(torch.autograd.Function):
    """Forward: the hand-written kernel.  Backward: the autograd gradient
    of ``plain(q, k, v, causal)``, recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, plain):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.plain = causal, plain
        return _fa.flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, g):
        causal, plain = ctx.causal, ctx.plain
        grads = _plain_grads(ctx, lambda q, k, v: plain(q, k, v, causal),
                             ctx.saved_tensors, (g,))
        return (*grads, None, None)


class SSDScanFn(torch.autograd.Function):
    """Forward: the hand-written SSD scan, (y, final state).  Backward:
    the autograd gradient of y of ``plain(xh, bv, cv, dt, a, state0)``
    (which returns (y, state)), recomputed on the saved inputs.  The
    final state carries no gradient."""

    @staticmethod
    def forward(ctx, xh, bv, cv, dt, a, state0, plain):
        ctx.save_for_backward(xh, bv, cv, dt, a, state0)
        ctx.plain = plain
        y, state = _ssd.ssd_scan(xh, bv, cv, dt, a, state0)
        ctx.mark_non_differentiable(state)
        return y, state

    @staticmethod
    def backward(ctx, gy, _gstate):
        grads = _plain_grads(ctx, ctx.plain, ctx.saved_tensors, (gy,))
        return (*grads, None)


def flash_attention(q, k, v, *, causal: bool = True, impl=None,
                    backward=None):
    """Blockwise GQA attention (the Pallas ``flash_attention``'s
    function): q (B, S, H, D), k/v (B, T, KH, D) -> (B, S, H, D) in q's
    dtype, head h reading kv head h // (H // KH).  ``backward(q, k, v,
    causal)``: the plain function the model trains through.  Under
    autograd the kernel's output takes its gradient (a kernel call that
    autograd must differentiate raises without it), and the plain path
    runs it in place of the plain twin, so both paths differentiate the
    same function."""
    if resolve_impl(q, impl) == "kernel":
        if _wants_grad(q, k, v):
            if backward is None:
                raise ValueError("flash_attention needs backward= to be "
                                 "differentiated on the kernel path")
            return FlashAttentionFn.apply(q, k, v, causal, backward)
        return _fa.flash_attention(q, k, v, causal=causal)
    if backward is not None and _wants_grad(q, k, v):
        return backward(q, k, v, causal)
    return ref.flash_attention(q, k, v, causal=causal)


def ssd_scan(xh, bv, cv, dt, a, state0=None, *, impl=None, backward=None):
    """The Mamba2 SSD scan: (y (B, S, H, hd) in xh's dtype, final state
    (B, H, hd, N) f32), from ``state0`` (zeros if None).
    ``backward(xh, bv, cv, dt, a, state0) -> (y, state)``: the plain
    function the model trains through, as in :func:`flash_attention`."""
    if resolve_impl(xh, impl) == "kernel":
        if _wants_grad(xh, bv, cv, dt, a, state0):
            if backward is None:
                raise ValueError("ssd_scan needs backward= to be "
                                 "differentiated on the kernel path")
            return SSDScanFn.apply(xh, bv, cv, dt, a, state0, backward)
        return _ssd.ssd_scan(xh, bv, cv, dt, a, state0)
    if backward is not None and _wants_grad(xh, bv, cv, dt, a, state0):
        return backward(xh, bv, cv, dt, a, state0)
    return ref.ssd_scan(xh, bv, cv, dt, a, state0)
