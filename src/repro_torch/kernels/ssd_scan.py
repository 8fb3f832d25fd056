"""Wrapper of the hand-written SSD scan (``csrc/ssd_scan.cu``).

Replaces the Pallas ``repro.kernels.ssd_scan.ssd_scan``
(``src/repro/kernels/ssd_scan.py:55``) and the chunked jnp SSD the JAX
model runs in its place: the port's ``ssd_chunked`` (every SSM prefill)
comes here.  It returns y and the final state, from an optional initial
state.  The kernel runs the plain recurrence, so it takes no chunk length.
CUDA tensors only; the plain version is
:func:`repro_torch.kernels.ref.ssd_scan` and :mod:`repro_torch.kernels.ops`
picks.

Bound: bytes (see the source).  ``launches`` counts the calls that
launched the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.radix_partition import _raise_on

launches = {"ssd": 0}
DTYPES = (torch.float32, torch.bfloat16)

_P, _I = ctypes.c_void_p, ctypes.c_int
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("ssd_scan")
        lib.ssd_scan_fwd.argtypes = [_P] * 8 + [_I] * 6 + [_P]
        lib.ssd_scan_fwd.restype = _I
        _lib = lib
    return _lib


def takes_state_dim(n: int) -> bool:
    """State widths the kernel takes (``state_per_lane`` in the source):
    N = NPT * 2**k with NPT in {4, 8, 16, 32} and 2**k <= 32."""
    for npt in (32, 16, 8, 4):
        ns = n // npt
        if n % npt == 0 and 1 <= ns <= 32 and ns & (ns - 1) == 0:
            return True
    return False


def _check(t, name, dtype, shape, device):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def ssd_scan(xh: torch.Tensor, bv: torch.Tensor, cv: torch.Tensor,
             dt: torch.Tensor, a: torch.Tensor, state0=None):
    """xh (B, S, H, hd) and bv/cv (B, S, N) of one dtype (f32 or bf16),
    dt (B, S, H) f32, a (H,) f32, state0 (B, H, hd, N) f32 or None (zeros).
    Returns (y (B, S, H, hd) in xh's dtype, final state (B, H, hd, N)
    f32)."""
    if not xh.is_cuda:
        raise ValueError(f"xh must be a CUDA tensor, got {xh.device}")
    if xh.dtype not in DTYPES or xh.dim() != 4:
        raise TypeError(f"xh must be 4-D in {DTYPES}, got {xh.dtype} "
                        f"{tuple(xh.shape)}")
    B, S, H, P = xh.shape
    N = bv.shape[-1]
    dev = xh.device
    _check(bv, "bv", xh.dtype, (B, S, N), dev)
    _check(cv, "cv", xh.dtype, (B, S, N), dev)
    _check(dt, "dt", torch.float32, (B, S, H), dev)
    _check(a, "a", torch.float32, (H,), dev)
    if state0 is not None:
        _check(state0, "state0", torch.float32, (B, H, P, N), dev)
        state0 = state0.contiguous()
    if not takes_state_dim(N):
        raise ValueError(f"state width N={N} is not 4, 8, 16 or 32 times a "
                         "power of two up to 32")
    if min(B, S, H, P) < 1 or max(B, H) > 65535:
        raise ValueError(f"B={B}, S={S}, H={H}, hd={P} out of the kernel's "
                         "range")
    xh, bv, cv, dt, a = (t.contiguous() for t in (xh, bv, cv, dt, a))
    y = torch.empty_like(xh)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(lib.ssd_scan_fwd(
            xh.data_ptr(), bv.data_ptr(), cv.data_ptr(), dt.data_ptr(),
            a.data_ptr(), None if state0 is None else state0.data_ptr(),
            y.data_ptr(), state.data_ptr(), B, S, H, P, N,
            int(xh.dtype == torch.bfloat16), stream), "ssd_scan launch")
    launches["ssd"] += 1
    return y, state
