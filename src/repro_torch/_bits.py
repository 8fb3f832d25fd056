"""u32 words carried as ``torch.int32`` bit patterns, and the device rule.

``torch.uint32`` lacks add, shifts, ``index_put_`` and ``maximum``, so every
32-bit word of the protocol (lock|CID words, CIDs, payload, wire lanes) is
an ``int32`` tensor holding the same bits.  Equality and ``& | ^`` are the
same on both views; order and arithmetic go through :func:`u32` (int64
values in ``[0, 2**32)``) and back through :func:`to_i32`.  Byte counters
bill ``element_size()``, which is 4 either way.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
LOCK_BIT = -(1 << 31)          # 1 << 31 as an int32 bit pattern
CID_MASK = 0x7FFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 unsigned values."""
    return x.to(torch.int64) & M32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values (taken mod 2**32) -> int32 bit patterns."""
    x = x & M32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """u32 product mod 2**32 of int64 values in ``[0, 2**32)`` (``b`` a
    tensor or an int), in int64 without signed overflow: ``b`` is split
    into 16-bit halves, so no partial product reaches 2**49."""
    lo = a * (b & 0xFFFF)
    hi = (a * (b >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & M32


def put_rows(dst: torch.Tensor, idx: torch.Tensor, values: torch.Tensor,
             keep: torch.Tensor) -> torch.Tensor:
    """``dst[idx[keep]] = values[keep]`` in place, without a host sync: a
    bool-mask index runs ``nonzero``, whose size the host must read from
    the device.  The dropped requests go to row 0, which then gets back
    its old contents or, if a kept request names it, the last such
    request's row.  Returns ``dst``."""
    if idx.numel() == 0 or dst.shape[0] == 0:
        return dst
    idx = torch.where(keep, idx.to(torch.int64), 0)
    values = values.to(dst.dtype)
    row0 = dst[0].clone()
    dst[idx] = values
    pos = torch.arange(idx.shape[0], device=idx.device)
    last = torch.where(keep & (idx == 0), pos, -1).max()
    # a 1-element index: a 0-d one would be read by the host
    src = values[last.clamp(min=0).reshape(1)][0]
    dst[0] = torch.where(last >= 0, src, row0)
    return dst


def np_to_i32(a) -> np.ndarray:
    """numpy u32 (or anything castable to it) -> int32 bit view."""
    return np.ascontiguousarray(np.asarray(a).astype(np.uint32)).view(
        np.int32)


def np_u32(x) -> np.ndarray:
    """int32 bit-pattern tensor (any device) or array -> numpy uint32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    if x.dtype == np.int32:
        return x.view(np.uint32)
    return x.astype(np.uint32)


def resolve_device(device=None) -> torch.device:
    """The port's device rule: ``None`` means the card, and a missing card
    raises; the CPU runs only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device
