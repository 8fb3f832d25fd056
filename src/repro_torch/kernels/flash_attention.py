"""Wrapper of the hand-written attention kernel (``csrc/flash_attention.cu``).

Replaces the Pallas ``repro.kernels.flash_attention.flash_attention``
(``src/repro/kernels/flash_attention.py:67``) and the chunked stand-in the
JAX model runs in its place: the port's ``grouped_attend`` sends every
full-sequence call here: causal self-attention (every prefill), and
non-causal attention with any key count T (whisper's encoder, the VLM's
and whisper's cross-attention).  CUDA tensors only; the plain
version is :func:`repro_torch.kernels.ref.flash_attention` and
:mod:`repro_torch.kernels.ops` picks.

The bf16 body is built for the padded (q.k, v) widths (64, 64), (128, 128)
and (192, 128); the last is the MLA entry (DeepSeek-V2's q.k 192 = nope
128 + rope 64, v 128), which the JAX package gives to its chunked
stand-in.  The f32 body takes one width.

Bound: operations at long sequences (see the source).  ``launches`` counts
the calls that launched each entry: ``flash`` the causal calls of the bf16
bodies of widths up to 128 and of the f32 body, ``flash_noncausal`` their
non-causal calls (the same bodies, every key of T read), ``mla`` the
(192, 128) body.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.radix_partition import _raise_on

launches = {"flash": 0, "flash_noncausal": 0, "mla": 0}
# the device kernels each entry point launches, as the profiler names them
KERNELS = {"flash": ("flash_bf16", "flash_f32"),
           "flash_noncausal": ("flash_bf16", "flash_f32"),
           "mla": ("flash_bf16",)}
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128
MAX_QK_DIM = 192       # bf16 q.k width with v at most MAX_HEAD_DIM: the MLA
                       # entry
# the f32 body (flash_f32): keys a tile by padded head width (csrc
# F32Layout::BK)
F32_TILE_KEYS = {32: 64, 64: 64, 128: 48}

_P, _I = ctypes.c_void_p, ctypes.c_int
_lib = None
_lock = threading.Lock()       # the load, the launch and its count


def _load():
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        lib.flash_attention_fwd.argtypes = [_P, _P, _P, _P] + [_I] * 9 + [_P]
        lib.flash_attention_fwd.restype = _I
        _lib = lib
    return _lib


def takes_head_dim(d: int) -> bool:
    """Head widths the kernel takes for q, k and v alike, in either dtype:
    multiples of 8 up to 128."""
    return takes_widths(d, d, torch.float32)


def takes_widths(d_qk: int, d_v: int, dtype) -> bool:
    """(q.k width, v width) pairs the kernel takes: multiples of 8; in
    bf16 q.k up to 192 and v up to 128, in f32 one width up to 128."""
    if not (d_qk % 8 == 0 and d_v % 8 == 0 and d_qk > 0 and d_v > 0):
        return False
    if dtype == torch.bfloat16:
        return d_qk <= MAX_QK_DIM and d_v <= MAX_HEAD_DIM
    return d_qk == d_v <= MAX_HEAD_DIM


def entry(d_qk: int, causal: bool = True) -> str:
    """The ``launches`` key of a call: ``mla`` for a q.k width above 128,
    else ``flash`` or ``flash_noncausal``."""
    if d_qk > MAX_HEAD_DIM:
        return "mla"
    return "flash" if causal else "flash_noncausal"


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself when contiguous with a 16-byte aligned start (the f32
    body's copies are 16 bytes wide, and TMA reads the bf16 tensors from
    16-byte aligned addresses), else such a copy."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """(B, S, T, H, KH, D, Dv) of a call the kernel takes; raises on any
    other."""
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
    T, KH, Dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape != (B, T, KH, D) or v.shape != (B, T, KH, Dv):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if KH < 1 or H % KH:
        raise ValueError(f"H={H} is not a multiple of KH={KH}")
    if not takes_widths(D, Dv, q.dtype):
        raise ValueError(f"head widths (q.k {D}, v {Dv}) in {q.dtype}: the "
                         "kernel takes multiples of 8, in bf16 q.k up to "
                         f"{MAX_QK_DIM} and v up to {MAX_HEAD_DIM}, in f32 "
                         f"one width up to {MAX_HEAD_DIM}")
    n_qt = -(-S // 128)
    if min(B, S, T) < 1 or max(B, H, n_qt) > 65535 \
            or B * H * n_qt >= 2 ** 31:
        raise ValueError(f"B={B}, S={S}, T={T}, H={H} out of the kernel's "
                         "range")
    return B, S, T, H, KH, D, Dv


# shapes, dtypes and devices of q, k, v that _check took, and its result:
# a call like an earlier one is not checked again
_checked: dict = {}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, out=None) -> torch.Tensor:
    """q (B, S, H, D), k (B, T, KH, D), v (B, T, KH, Dv), one dtype (f32
    or bf16), H % KH == 0, (D, Dv) a pair :func:`takes_widths` accepts.
    Returns (B, S, H, Dv) in q's dtype; head h reads kv head h // (H //
    KH).  ``out``, if given, a contiguous, 16-byte aligned tensor of that
    shape, dtype and device, is written and returned."""
    sig = (q.shape, k.shape, v.shape, q.dtype, k.dtype, v.dtype,
           q.get_device(), k.get_device(), v.get_device())
    dims = _checked.get(sig)
    if dims is None:
        dims = _check(q, k, v)
        if len(_checked) < 1024:
            _checked[sig] = dims
    B, S, T, H, KH, D, Dv = dims
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    if out is None:
        out = q.new_empty((B, S, H, Dv))
    elif (out.shape != (B, S, H, Dv) or out.dtype != q.dtype
          or out.device != q.device or not out.is_contiguous()
          or out.data_ptr() % 16):
        raise ValueError(f"out must be a contiguous, 16-byte aligned "
                         f"{(B, S, H, Dv)} {q.dtype} tensor on {q.device}")
    lib = _lib or _load()
    dev = sig[6]
    # the raw handle of the current stream, as Triton's launcher reads it
    # (torch.cuda.current_stream() builds an object a call)
    stream = torch._C._cuda_getCurrentRawStream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            T, H, KH, D, Dv, int(bool(causal)),
            int(q.dtype == torch.bfloat16))
    with _lock:
        if dev == torch.cuda.current_device():
            rc = lib.flash_attention_fwd(*args, stream(dev))
        else:
            with torch.cuda.device(dev):
                rc = lib.flash_attention_fwd(*args, stream(dev))
        _raise_on(rc, "flash_attention launch")
        launches[entry(D, causal)] += 1
    return out
