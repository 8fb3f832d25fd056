"""Wrapper of the hand-written CAS arbitration kernel (``csrc/cas_lock.cu``).

Replaces the Pallas ``repro.kernels.cas_lock.cas_lock``
(``src/repro/kernels/cas_lock.py:53``) with the semantics of the verb the
JAX commit runs, ``repro.fabric.verbs.cas`` (priority and ``new=``), of
which ``cas_lock`` is the case priority = arrival, new = expected | LOCK.
Like the Pallas kernel, it updates the words in place.  CUDA tensors only;
the plain version is :func:`repro_torch.kernels.ref.cas`.

Bound: bytes (see the source); at the commit's shape a call costs its
launch and this wrapper's host work, so a call is one cooperative launch,
and the wrapper allocates only ``ok``.  ``launches["cas"]`` counts the
calls that launched it.  ``_lock`` covers the host section (the scratch
handed to the library, the launch and its count): shards of a
``MeshTransport`` call in from several threads at once, on one stream,
whose order keeps the shared scratch's calls apart on the device.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.radix_partition import _check, _raise_on, _stream

launches = {"cas": 0}
# the device kernels each entry point launches, as the profiler names them
KERNELS = {"cas": ("cas_kernel",)}

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_I32 = torch.int32
_lib = None
_lock = threading.Lock()


def _load():
    global _lib
    if _lib is None:
        lib = build.load("cas_lock")
        lib.cas_arbitrate.argtypes = [_P, _L, _P, _P, _P, _P, _L, _P, _I, _P]
        lib.cas_arbitrate.restype = _I
        lib.cas_scratch.argtypes = [_I, _P, _P]
        lib.cas_scratch.restype = _I
        _lib = lib
    return _lib


# The kernel's scratch, one pair per device index, handed to the library
# once: the per-word arbitration table (u64 keys) and slot R's two minima
# (u32).  The table and the first minimum hold all ones between calls (the
# kernel resets what it touched).  The table grows when R does; a failed
# launch drops the pair, so the next call starts from a fresh fill.
_scratch: dict = {}


def _scratch_of(R: int, di: int):
    s = _scratch.get(di)
    if s is None or s[0] < R:
        best = torch.full((R,), -1, dtype=torch.int64, device=f"cuda:{di}")
        slot_r = torch.full((2,), -1, dtype=torch.int32, device=f"cuda:{di}")
        _raise_on(_load().cas_scratch(di, best.data_ptr(), slot_r.data_ptr()),
                  "cas_scratch")
        s = _scratch[di] = (R, best, slot_r)
    return s


def arbitration_scratch(R: int, device):
    """``(best, slot_r)`` of ``device``, the table at least R entries
    long."""
    di = torch.device(device).index
    with _lock:
        return _scratch_of(R, torch.cuda.current_device() if di is None
                           else di)[1:]


def cas(words, idx, expected, new, priority):
    """Arbitrate (A,) CAS requests against ``words`` (R,) in place.
    Returns ``ok`` (A,) bool.  All arguments int32, contiguous, 1-D, on one
    CUDA device."""
    di = words.get_device()
    A = idx.shape[0] if idx.dim() == 1 else -1
    if not (di >= 0 and A >= 0 and words.dtype is _I32 and idx.dtype is _I32
            and expected.dtype is _I32 and new.dtype is _I32
            and priority.dtype is _I32 and idx.get_device() == di
            and expected.get_device() == di and new.get_device() == di
            and priority.get_device() == di and words.dim() == 1
            and expected.shape == idx.shape
            and new.shape == idx.shape and priority.shape == idx.shape
            and words.is_contiguous() and idx.is_contiguous()
            and expected.is_contiguous() and new.is_contiguous()
            and priority.is_contiguous()):
        _check(words, "words", _I32, 1)
        for name, t in (("idx", idx), ("expected", expected), ("new", new),
                        ("priority", priority)):
            _check(t, name, _I32, 1, words.device)
            if t.shape[0] != A:
                raise ValueError(f"{name} has {t.shape[0]} entries, idx has "
                                 f"{A}")
    R = words.shape[0]
    if R < 1 or A >= 2 ** 32 - 1:
        raise ValueError(f"cas needs 1 <= R and A < 2**32-1 (R={R}, A={A})")
    ok = torch.empty_like(idx, dtype=torch.bool)
    if A == 0:
        return ok
    with _lock:
        _scratch_of(R, di)
        err = (_lib or _load()).cas_arbitrate(
            words.data_ptr(), R, idx.data_ptr(), expected.data_ptr(),
            new.data_ptr(), priority.data_ptr(), A, ok.data_ptr(), di,
            _stream(di))
        if err != 0:
            _scratch.pop(di, None)             # it may hold stale keys
            _raise_on(err, "cas_arbitrate launch")
        launches["cas"] += 1
    return ok
