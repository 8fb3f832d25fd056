"""Wrapper of the hand-written SSD scan (``csrc/ssd_scan.cu``).

Replaces the Pallas ``repro.kernels.ssd_scan.ssd_scan``
(``src/repro/kernels/ssd_scan.py:55``) and the chunked jnp SSD the JAX
model runs in its place: the port's ``ssd_chunked`` (every SSM prefill)
comes here.  It returns y and the final state, from an optional initial
state.  Both input types run the chunked SSD on the tensor cores
(``ssd_chunk_bf16``, ``ssd_chunk_f32``: f32 x, B and C split into bf16
high parts and remainders, three MMAs a product), which picks its own
chunk length.  CUDA tensors only; the plain version is
:func:`repro_torch.kernels.ref.ssd_scan` and :mod:`repro_torch.kernels.ops`
picks.

Bound: bytes (see the source).  ``launches`` counts the calls that
launched the kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.radix_partition import _raise_on

launches = {"ssd": 0}
# the device kernels each entry point launches, as the profiler names them
KERNELS = {"ssd": ("ssd_chunk_bf16", "ssd_chunk_f32")}
DTYPES = (torch.float32, torch.bfloat16)

_P, _I = ctypes.c_void_p, ctypes.c_int
_lib = None
_lock = threading.Lock()       # the load, the launch and its count


def _load():
    global _lib
    if _lib is None:
        lib = build.load("ssd_scan")
        lib.ssd_scan_fwd.argtypes = [_P] * 8 + [_I] * 6 + [_P]
        lib.ssd_scan_fwd.restype = _I
        lib.ssd_chunk_plan.argtypes = [_I, _I, _I, _P]
        lib.ssd_chunk_plan.restype = _I
        _lib = lib
    return _lib


def takes_state_dim(n: int) -> bool:
    """State widths the kernel takes, the same for both input types:
    1 <= N <= 1024, zero-padded by the wrapper to a power of two from
    8."""
    return 1 <= n <= 1024


def chunk_plan(P: int, N: int, device=None,
               dtype=torch.bfloat16) -> dict:
    """The chunked body's chunk length, hd tile, shared bytes and staging
    buffers for inputs of ``dtype``, head width P (a multiple of 8) and
    state width N (a power of two from 8) on ``device`` (the current card
    by default)."""
    out = (ctypes.c_int * 4)()
    lib = _load()
    with torch.cuda.device(device):
        _raise_on(lib.ssd_chunk_plan(P, N, int(dtype == torch.bfloat16),
                                     out), "ssd_chunk_plan")
    return {"L": out[0], "hd_tile": out[1], "smem_bytes": out[2],
            "buffers": out[3]}


def _pad(t: torch.Tensor, sizes: dict) -> torch.Tensor:
    """``t`` zero-padded at the end of each dim in ``sizes`` to that
    size."""
    pad = []
    for d in range(t.dim() - 1, -1, -1):
        pad += [0, sizes.get(d, t.shape[d]) - t.shape[d]]
    return torch.nn.functional.pad(t, pad) if any(pad) else t


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
        raise ValueError(f"state width N={N} is not taken: the kernel takes "
                         "1..1024 in either type")
    if min(B, S, H, P) < 1 or max(B, H) > 65535:
        raise ValueError(f"B={B}, S={S}, H={H}, hd={P} out of the kernel's "
                         "range")
    xh, bv, cv, dt, a = (t.contiguous() for t in (xh, bv, cv, dt, a))
    bf16 = xh.dtype == torch.bfloat16
    # the chunked body reads 16-byte rows: hd a multiple of 8, N a power of
    # two from 8; zero columns add nothing to y or the state
    PP, NP = -(-P // 8) * 8, max(8, 1 << (N - 1).bit_length())
    if (PP, NP) != (P, N):
        xh = _pad(xh, {3: PP})
        bv, cv = _pad(bv, {2: NP}), _pad(cv, {2: NP})
        if state0 is not None:
            state0 = _pad(state0, {2: PP, 3: NP})
    xh, bv, cv = _aligned(xh), _aligned(bv), _aligned(cv)
    y = torch.empty_like(xh)
    state = torch.empty((B, H, PP, NP), dtype=torch.float32, device=dev)
    with _lock, torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(_load().ssd_scan_fwd(
            xh.data_ptr(), bv.data_ptr(), cv.data_ptr(), dt.data_ptr(),
            a.data_ptr(), None if state0 is None else state0.data_ptr(),
            y.data_ptr(), state.data_ptr(), B, S, H, PP, NP, int(bf16),
            stream), "ssd_scan launch")
        launches["ssd"] += 1
    if (PP, NP) != (P, N):
        return (y[..., :P].contiguous(),
                state[:, :, :P, :N].contiguous())
    return y, state
