"""The plain OLAP answers: an equi-join's aggregate and grouped sums.

Columns are u32 words held as int32 bit patterns.  ``precision="exact"``
computes in int64 and keeps the low 32 bits, as the configuration states
(u32 sums that wrap at 2**32).  ``precision="f32"`` is the control: the
same reference with keys and values in float32, the nearest precision
below, which a later change might be tempted to take.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
BLOCK = 1 << 24          # probe rows a block, so the reference fits


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & M32


def join_sum(rk, rv, sk, sv, *, precision: str = "exact") -> int:
    """u32 sum over S's rows of rv * sv for the R row of equal key (R's
    keys unique), mod 2**32."""
    if precision == "f32":
        rkf, order = torch.sort(_u32(rk).to(torch.float32))
        rvf = _u32(rv).to(torch.float32)[order]
        total = torch.zeros((), dtype=torch.float32, device=rk.device)
        for a in range(0, sk.shape[0], BLOCK):
            k = _u32(sk[a:a + BLOCK]).to(torch.float32)
            pos = torch.searchsorted(rkf, k).clamp(max=rkf.shape[0] - 1)
            hit = rkf[pos] == k
            prod = rvf[pos] * _u32(sv[a:a + BLOCK]).to(torch.float32)
            total += torch.where(hit, prod, 0).sum()
        return int(total.to(torch.float64).item()) & M32
    if precision != "exact":
        raise ValueError(f"unknown precision {precision!r}")
    rks, order = torch.sort(_u32(rk))
    rvs = _u32(rv)[order]
    total = 0
    for a in range(0, sk.shape[0], BLOCK):
        k = _u32(sk[a:a + BLOCK])
        pos = torch.searchsorted(rks, k).clamp(max=rks.shape[0] - 1)
        hit = rks[pos] == k
        # int64 products wrap mod 2**64, which keeps their low 32 bits
        prod = (rvs[pos] * _u32(sv[a:a + BLOCK])) & M32
        total += int(torch.where(hit, prod, 0).sum())
    return total & M32


def group_sums(keys, vals, groups: int, *,
               precision: str = "exact") -> torch.Tensor:
    """(groups,) u32 sums of ``vals`` by ``key % groups``, as int64 values
    in [0, 2**32)."""
    if precision == "f32":
        slot = torch.remainder(_u32(keys).to(torch.float32), groups)
        slot = slot.to(torch.int64).clamp(0, groups - 1)
        out = torch.zeros((groups,), dtype=torch.float32, device=keys.device)
        out.index_add_(0, slot, _u32(vals).to(torch.float32))
        return out.to(torch.int64) & M32
    if precision != "exact":
        raise ValueError(f"unknown precision {precision!r}")
    out = torch.zeros((groups,), dtype=torch.int64, device=keys.device)
    for a in range(0, keys.shape[0], BLOCK):
        out.index_add_(0, _u32(keys[a:a + BLOCK]) % groups,
                       _u32(vals[a:a + BLOCK]))
    return out & M32
