"""Wrappers of the hand-written radix partitioner (``csrc/radix_partition.cu``).

Replaces the Pallas ``repro.kernels.radix_partition.radix_partition``
(``src/repro/kernels/radix_partition.py:59``) and the jnp plan + scatter
the JAX router runs in its place.  :func:`rank` is ``plan_route``'s slot
assignment, :func:`scatter` the wire scatter with the valid lane fused.
Both take CUDA tensors only; the plain versions are in
:mod:`repro_torch.kernels.ref` and :mod:`repro_torch.kernels.ops` picks.
The scatter takes the rank's ``counts``: it writes every slot of the
buffer once, rows where the rank put them and zeros after each bucket's
``counts[d]`` kept slots, so the buffer needs no fill.

Bound: bytes (see the source).  ``launches`` counts the calls that
launched each entry point.

Shards of a ``MeshTransport`` call in from several host threads at once,
on one stream.  ``_lock`` covers each wrapper's host section: the rank's
shared histogram buffer, its three launches (``ctypes`` drops the GIL
during the call, and another thread's rank must not run between them),
and the counts.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

launches = {"rank": 0, "scatter": 0}
# the device kernels each entry point launches, as the profiler names them
KERNELS = {"rank": ("hist_kernel", "scan_kernel", "rank_kernel"),
           "scatter": ("scatter_narrow", "scatter_medium", "scatter_wide")}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_I32 = torch.int32
_lib = None
_lock = threading.Lock()
# requests a rank block takes, and the largest n whose per-warp counts fit
# the 48 KB of shared memory a block gets without opting in
_items = _max_n = 0


def _load():
    """The library, loaded once (under ``_lock``)."""
    global _lib, _items, _max_n
    if _lib is None:
        lib = build.load("radix_partition")
        lib.radix_rank.argtypes = [_P, _L, _I, _I, _P, _P, _P, _P, _P, _I,
                                   _P]
        lib.radix_rank.restype = _I
        lib.radix_scatter.argtypes = [_P, _P, _P, _P, _L, _I, _I, _L, _P,
                                      _I, _P]
        lib.radix_scatter.restype = _I
        for fn in (lib.radix_items_per_block, lib.radix_warps_per_block):
            fn.argtypes = []
            fn.restype = _I
        _items = lib.radix_items_per_block()
        _max_n = (48 * 1024) // (4 * (lib.radix_warps_per_block() + 1))
        _lib = lib
    return _lib


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


# _stream(di): the handle of device di's current stream, what
# torch.cuda.current_stream(di).cuda_stream gives without building a Stream
# object on every launch (absent from builds without CUDA, which launch
# nothing).
_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


# The rank's per-block histograms, one int32 buffer per device index,
# grown when a call needs more; each call overwrites what it reads.
_hist: dict = {}


def rank(dest: torch.Tensor, n: int, cap: int):
    """Stable rank-in-bucket of ``dest`` (A,) int32.  Returns ``(slot
    (A,) int32, keep (A,) bool, overflow (A,) bool, counts (n,) int32)``:
    ``slot = dest*cap + rank`` where kept, ``n*cap`` otherwise;
    ``counts = min(bucket size, cap)``.  slot and counts share one
    allocation, keep and overflow another."""
    di = dest.get_device()
    if di < 0 or not (dest.dtype is _I32 and dest.dim() == 1
                      and dest.is_contiguous()):
        _check(dest, "dest", _I32, 1)
    n, cap = int(n), int(cap)
    if cap < 0 or n * (cap + 1) >= 2 ** 31:
        raise ValueError(f"n*cap = {n}*{cap} does not fit int32 slots")
    A = dest.shape[0]
    out = torch.empty((A + n,), dtype=_I32, device=di)
    flags = torch.empty((2, A), dtype=torch.bool, device=di)
    with _lock:
        lib = _lib or _load()
        if not 1 <= n <= _max_n:
            raise ValueError(f"n={n} outside [1, {_max_n}]")
        need = max(-(-A // _items), 1) * n
        hist = _hist.get(di)
        if hist is None or hist.shape[0] < need:
            hist = _hist[di] = torch.empty((need,), dtype=_I32, device=di)
        _raise_on(lib.radix_rank(dest.data_ptr(), A, n, cap, hist.data_ptr(),
                                 out.data_ptr() + 4 * A, out.data_ptr(),
                                 flags.data_ptr(), flags.data_ptr() + A, di,
                                 _stream(di)), "radix_rank launch")
        launches["rank"] += 1
    return out[:A], flags[0], flags[1], out[A:]


def scatter(rows: torch.Tensor, slot: torch.Tensor, num_slots: int, *,
            counts: torch.Tensor, mask=None) -> torch.Tensor:
    """Scatter ``rows`` (A, w) int32 into a (num_slots, w + 1) int32
    buffer: row i lands in ``slot[i]``, with a ones valid lane appended,
    when the slot is in range and ``mask[i]`` (if given) is set; every
    other int is 0.  ``slot`` and ``counts`` (n,) are :func:`rank`'s for
    ``cap = num_slots / n``: bucket d's kept rows fill its first
    ``counts[d]`` slots, so the kernel zeros only the rest."""
    di = rows.get_device()
    A = rows.shape[0]
    if di < 0 or not (
            rows.dtype is _I32 and rows.dim() == 2 and rows.is_contiguous()
            and slot.dtype is _I32 and slot.get_device() == di
            and slot.dim() == 1 and slot.is_contiguous()
            and slot.shape[0] == A and counts.dtype is _I32
            and counts.get_device() == di and counts.dim() == 1
            and counts.is_contiguous() and (mask is None or (
                mask.dtype is torch.bool and mask.get_device() == di
                and mask.dim() == 1 and mask.is_contiguous()
                and mask.shape[0] == A))):
        _check(rows, "rows", _I32, 2)
        _check(slot, "slot", _I32, 1, rows.device)
        _check(counts, "counts", _I32, 1, rows.device)
        if mask is not None:
            _check(mask, "mask", torch.bool, 1, rows.device)
        for name, t in (("slot", slot), ("mask", mask)):
            if t is not None and t.shape[0] != A:
                raise ValueError(f"{name} has {t.shape[0]} entries for {A} "
                                 "rows")
    n, w, num_slots = counts.shape[0], rows.shape[1], int(num_slots)
    if n < 1 or num_slots % n:
        raise ValueError(f"num_slots={num_slots} is not counts.numel()={n} "
                         "times a cap")
    out = torch.empty((num_slots, w + 1), dtype=_I32, device=di)
    with _lock:
        err = (_lib or _load()).radix_scatter(
            rows.data_ptr(), slot.data_ptr(),
            None if mask is None else mask.data_ptr(), counts.data_ptr(), A,
            w, n, num_slots // n, out.data_ptr(), di, _stream(di))
        _raise_on(err, "radix_scatter launch")
        launches["scatter"] += 1
    return out
