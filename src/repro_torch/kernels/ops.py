"""Dispatch between each kernel and its plain version.

``impl=None`` picks by where the tensor lies: the hand-written kernel for
a CUDA tensor, the plain version (:mod:`repro_torch.kernels.ref`) for a
CPU tensor.  ``impl="kernel"`` on a CPU tensor raises.  ``impl="plain"``
runs the plain version on any device; it exists for the tests and for
``chip_smoke.py``'s comparison, never as a fallback: a kernel that fails
to build or launch raises.
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


def flash_attention(q, k, v, *, causal: bool = True, impl=None):
    """Blockwise GQA attention (the Pallas ``flash_attention``'s
    function): q (B, S, H, D), k/v (B, T, KH, D) -> (B, S, H, D) in q's
    dtype, head h reading kv head h // (H // KH)."""
    if resolve_impl(q, impl) == "kernel":
        return _fa.flash_attention(q, k, v, causal=causal)
    return ref.flash_attention(q, k, v, causal=causal)


def ssd_scan(xh, bv, cv, dt, a, state0=None, *, impl=None):
    """The Mamba2 SSD scan: (y (B, S, H, hd) in xh's dtype, final state
    (B, H, hd, N) f32), from ``state0`` (zeros if None)."""
    if resolve_impl(xh, impl) == "kernel":
        return _ssd.ssd_scan(xh, bv, cv, dt, a, state0)
    return ref.ssd_scan(xh, bv, cv, dt, a, state0)
