"""Wrapper of the hand-written CAS arbitration kernel (``csrc/cas_lock.cu``).

Replaces the Pallas ``repro.kernels.cas_lock.cas_lock``
(``src/repro/kernels/cas_lock.py:53``) with the semantics of the verb the
JAX commit runs, ``repro.fabric.verbs.cas`` (priority and ``new=``), of
which ``cas_lock`` is the case priority = arrival, new = expected | LOCK.
Like the Pallas kernel, it updates the words in place.  CUDA tensors only;
the plain version is :func:`repro_torch.kernels.ref.cas`.

Bound: bytes (see the source).  ``launches["cas"]`` counts the calls that
launched it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.radix_partition import _check, _raise_on

launches = {"cas": 0}

_P, _L = ctypes.c_void_p, ctypes.c_longlong
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("cas_lock")
        lib.cas_arbitrate.argtypes = [_P, _L, _P, _P, _P, _P, _L, _P, _P, _P,
                                      _P]
        lib.cas_arbitrate.restype = ctypes.c_int
        _lib = lib
    return _lib


# The kernel's per-word arbitration table, one per device: u64 keys, all
# ones between calls (the kernel resets what it touched).  It grows when R
# does; a failed launch drops it, so the next call starts from a fresh fill.
_best: dict = {}


def arbitration_table(R: int, device) -> torch.Tensor:
    """The cached table of ``device``, at least R entries long."""
    b = _best.get(device)
    if b is None or b.numel() < R:
        b = _best[device] = torch.full((R,), -1, dtype=torch.int64,
                                       device=device)
    return b


def cas(words, idx, expected, new, priority):
    """Arbitrate (A,) CAS requests against ``words`` (R,) in place.
    Returns ``ok`` (A,) bool.  All arguments int32, on one CUDA device."""
    _check(words, "words", torch.int32, 1)
    dev = words.device
    for name, t in (("idx", idx), ("expected", expected), ("new", new),
                    ("priority", priority)):
        _check(t, name, torch.int32, 1, dev)
        if t.shape[0] != idx.shape[0]:
            raise ValueError(f"{name} has {t.shape[0]} entries, idx has "
                             f"{idx.shape[0]}")
    R, A = words.shape[0], idx.shape[0]
    if R < 1 or A >= 2 ** 32 - 1:
        raise ValueError(f"cas needs 1 <= R and A < 2**32-1 (R={R}, A={A})")
    lib = _load()
    best = arbitration_table(R, dev)
    slot_r = torch.empty((2,), dtype=torch.int32, device=dev)
    ok = torch.empty((A,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cas_arbitrate(
            words.data_ptr(), R, idx.data_ptr(), expected.data_ptr(),
            new.data_ptr(), priority.data_ptr(), A, best.data_ptr(),
            slot_r.data_ptr(), ok.data_ptr(), stream)
    if err != 0:
        _best.pop(dev, None)                   # it may hold stale keys
        _raise_on(err, "cas_arbitrate launch")
    launches["cas"] += 1
    return ok
