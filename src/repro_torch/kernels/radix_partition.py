"""Wrappers of the hand-written radix partitioner (``csrc/radix_partition.cu``).

Replaces the Pallas ``repro.kernels.radix_partition.radix_partition``
(``src/repro/kernels/radix_partition.py:59``) and the jnp plan + scatter
the JAX router runs in its place.  :func:`rank` is ``plan_route``'s slot
assignment, :func:`scatter` the wire scatter with the valid lane fused.
Both take CUDA tensors only; the plain versions are in
:mod:`repro_torch.kernels.ref` and :mod:`repro_torch.kernels.ops` picks.

Bound: bytes (see the source).  ``launches`` counts the calls that
launched each entry point.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = {"rank": 0, "scatter": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("radix_partition")
        lib.radix_rank.argtypes = [_P, _L, _I, _I, _P, _P, _P, _P, _P, _P]
        lib.radix_rank.restype = _I
        lib.radix_scatter.argtypes = [_P, _P, _P, _L, _I, _L, _P, _P]
        lib.radix_scatter.restype = _I
        for fn in (lib.radix_items_per_block, lib.radix_warps_per_block):
            fn.argtypes = []
            fn.restype = _I
        _lib = lib
    return _lib


def max_buckets() -> int:
    """Largest ``n`` whose per-warp counts fit the 48 KB of shared memory
    a block gets without opting in."""
    return (48 * 1024) // (4 * (_load().radix_warps_per_block() + 1))


def _check(t, name, dtype, ndim, device=None):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def rank(dest: torch.Tensor, n: int, cap: int):
    """Stable rank-in-bucket of ``dest`` (A,) int32.  Returns ``(slot
    (A,) int32, keep (A,) bool, overflow (A,) bool, counts (n,) int32)``:
    ``slot = dest*cap + rank`` where kept, ``n*cap`` otherwise;
    ``counts = min(bucket size, cap)``."""
    _check(dest, "dest", torch.int32, 1)
    lib = _load()
    n, cap = int(n), int(cap)
    if not 1 <= n <= max_buckets():
        raise ValueError(f"n={n} outside [1, {max_buckets()}]")
    if cap < 0 or n * (cap + 1) >= 2 ** 31:
        raise ValueError(f"n*cap = {n}*{cap} does not fit int32 slots")
    A = dest.numel()
    dev = dest.device
    nblocks = -(-A // lib.radix_items_per_block())
    hist = torch.empty((max(nblocks, 1) * n,), dtype=torch.int32, device=dev)
    slot = torch.empty((A,), dtype=torch.int32, device=dev)
    keep = torch.empty((A,), dtype=torch.bool, device=dev)
    overflow = torch.empty((A,), dtype=torch.bool, device=dev)
    counts = torch.empty((n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(lib.radix_rank(dest.data_ptr(), A, n, cap, hist.data_ptr(),
                                 counts.data_ptr(), slot.data_ptr(),
                                 keep.data_ptr(), overflow.data_ptr(),
                                 stream), "radix_rank launch")
    launches["rank"] += 1
    return slot, keep, overflow, counts


def scatter(rows: torch.Tensor, slot: torch.Tensor, num_slots: int, *,
            mask=None) -> torch.Tensor:
    """Scatter ``rows`` (A, w) int32 into a zeroed (num_slots, w + 1) int32
    buffer: row i lands in ``slot[i]``, with a ones valid lane appended,
    when the slot is in range and ``mask[i]`` (if given) is set."""
    _check(rows, "rows", torch.int32, 2)
    _check(slot, "slot", torch.int32, 1, rows.device)
    A, w = rows.shape
    if slot.shape[0] != A:
        raise ValueError(f"slot has {slot.shape[0]} entries for {A} rows")
    if mask is not None:
        _check(mask, "mask", torch.bool, 1, rows.device)
        if mask.shape[0] != A:
            raise ValueError(f"mask has {mask.shape[0]} entries for {A} rows")
    lib = _load()
    out = torch.empty((int(num_slots), w + 1), dtype=torch.int32,
                      device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        _raise_on(lib.radix_scatter(
            rows.data_ptr(), slot.data_ptr(),
            None if mask is None else mask.data_ptr(), A, w,
            int(num_slots), out.data_ptr(), stream), "radix_scatter launch")
    launches["scatter"] += 1
    return out
