"""Wrappers of the hand-written grouped scatter-add (``csrc/grouped_agg.cu``).

Replaces the Pallas ``repro.kernels.grouped_agg.grouped_agg``
(``src/repro/kernels/grouped_agg.py:41``) and the jnp scatter-adds the
JAX aggregation operators run in its place.  :func:`grouped_agg` is the
TPU kernel's function (f32 sums per slot); :func:`grouped_sum_u32` is the
same scatter-add on u32 words (int32 bit patterns) with a wrapping add,
which backs ``segment_sum_by_key``, ``preagg_table`` and RDMA-AGG's
partition table.  Both take CUDA tensors only; the plain versions are in
:mod:`repro_torch.kernels.ref` and :mod:`repro_torch.kernels.ops` picks.

Bound: bytes (see the source).  ``launches`` counts the calls that
launched each entry point.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.radix_partition import _check, _raise_on

launches = {"f32": 0, "u32": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("grouped_agg")
        for fn in (lib.grouped_agg_f32, lib.grouped_sum_u32):
            fn.argtypes = [_P, _P, _L, _I, _P, _P]
            fn.restype = _I
        lib.grouped_agg_max_shared_slots.argtypes = []
        lib.grouped_agg_max_shared_slots.restype = _I
        _lib = lib
    return _lib


def max_shared_slots() -> int:
    """Largest table the kernel keeps in shared memory, per block."""
    return _load().grouped_agg_max_shared_slots()


def _launch(entry: str, slot, vals, num_slots: int, dtype, what: str):
    _check(slot, "slot", torch.int32, 1)
    _check(vals, "vals", dtype, 1, slot.device)
    if vals.shape[0] != slot.shape[0]:
        raise ValueError(f"vals has {vals.shape[0]} rows, slot has "
                         f"{slot.shape[0]}")
    S = int(num_slots)
    if not 1 <= S < 2 ** 31:
        raise ValueError(f"num_slots={S} outside [1, 2**31)")
    lib = _load()
    dev = slot.device
    out = torch.empty((S,), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(getattr(lib, entry)(slot.data_ptr(), vals.data_ptr(),
                                      slot.shape[0], S, out.data_ptr(),
                                      stream), f"{entry} launch")
    launches[what] += 1
    return out


def grouped_agg(slot: torch.Tensor, vals: torch.Tensor,
                num_slots: int) -> torch.Tensor:
    """(num_slots,) f32 per-slot sums of ``vals`` (N,) f32 by ``slot``
    (N,) int32.  Rows whose slot lies outside [0, num_slots) are skipped.
    The order of the f32 additions changes from run to run."""
    return _launch("grouped_agg_f32", slot, vals, num_slots, torch.float32,
                   "f32")


def grouped_sum_u32(slot: torch.Tensor, vals: torch.Tensor,
                    num_slots: int) -> torch.Tensor:
    """(num_slots,) u32 per-slot sums mod 2**32 (int32 bit patterns) of the
    u32 words ``vals`` (N,) int32 by ``slot`` (N,) int32; exact in any
    order.  Rows whose slot lies outside [0, num_slots) are skipped."""
    return _launch("grouped_sum_u32", slot, vals, num_slots, torch.int32,
                   "u32")
