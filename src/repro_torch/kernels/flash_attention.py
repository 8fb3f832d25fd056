"""Wrapper of the hand-written attention kernel (``csrc/flash_attention.cu``).

Replaces the Pallas ``repro.kernels.flash_attention.flash_attention``
(``src/repro/kernels/flash_attention.py:67``) and the chunked stand-in the
JAX model runs in its place: the port's ``grouped_attend`` sends the causal
full-sequence case (every prefill) here.  CUDA tensors only; the plain
version is :func:`repro_torch.kernels.ref.flash_attention` and
:mod:`repro_torch.kernels.ops` picks.

Bound: operations at long sequences (see the source).  ``launches`` counts
the calls that launched the kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.radix_partition import _raise_on

launches = {"flash": 0}
# the device kernels each entry point launches, as the profiler names them
KERNELS = {"flash": ("flash_bf16", "flash_f32")}
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
_lib = None
_lock = threading.Lock()       # the load, the launch and its count


def _load():
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        lib.flash_attention_fwd.argtypes = [_P, _P, _P, _P] + [_I] * 8 + [_P]
        lib.flash_attention_fwd.restype = _I
        _lib = lib
    return _lib


def takes_head_dim(d: int) -> bool:
    """Head widths the kernel takes: multiples of 8 up to 128."""
    return d % 8 == 0 and 0 < d <= MAX_HEAD_DIM


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned start (the f32 body's copies are
    16 bytes wide, and TMA reads the bf16 tensors from 16-byte aligned
    addresses)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B, S, H, D), k/v (B, T, KH, D), one dtype (f32 or bf16), H % KH
    == 0, D a multiple of 8 up to 128.  Returns (B, S, H, D) in q's dtype;
    head h reads kv head h // (H // KH)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"q, k, v must share a dtype in {DTYPES}, got "
                            f"{q.dtype}, {k.dtype}, {v.dtype}")
        if t.dim() != 4 or t.device != q.device:
            raise ValueError(f"{name} must be 4-D on {q.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    if k.shape != (B, T, KH, D) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if KH < 1 or H % KH:
        raise ValueError(f"H={H} is not a multiple of KH={KH}")
    if not takes_head_dim(D):
        raise ValueError(f"head dim {D} is not a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}")
    if min(B, S, T) < 1 or max(B, H, -(-S // 128)) > 65535:
        raise ValueError(f"B={B}, S={S}, T={T}, H={H} out of the kernel's "
                         "range")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    with _lock, torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _raise_on(_load().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            T, H, KH, D, int(bool(causal)), int(q.dtype == torch.bfloat16),
            stream), "flash_attention launch")
        launches["flash"] += 1
    return out
