"""Mamba2 (SSD, state-space duality) block (a port of ``repro.models.ssm``).

The full-sequence path (every prefill) runs the hand-written SSD scan
through :func:`repro_torch.kernels.ops.ssd_scan`, which returns y and the
final state: the JAX model names that kernel as the "Pallas twin" of its
chunked scan but never calls it.  Decode is the one-token recurrence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import rmsnorm


def dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    gn = s.n_groups * s.d_state
    return d_in, nheads, gn


def build_ssm(cfg, mk):
    s = cfg.ssm
    d = cfg.d_model
    d_in, nheads, gn = dims(cfg)
    return {
        "wz": mk((d, d_in)), "wx": mk((d, d_in)), "wB": mk((d, gn)),
        "wC": mk((d, gn)), "wdt": mk((d, nheads)),
        "conv_x": mk((s.conv_kernel, d_in), 0.1),
        "conv_B": mk((s.conv_kernel, gn), 0.1),
        "conv_C": mk((s.conv_kernel, gn), 0.1),
        "A_log": mk((nheads,), "zeros"), "D": mk((nheads,), "ones"),
        "dt_bias": mk((nheads,), "zeros"), "gnorm": mk((d_in,), "zeros"),
        "wo": mk((d_in, d)),
    }


def _causal_conv(x, w, cache=None):
    """Depthwise causal conv.  x: (B, S, C); w: (K, C); cache: (B, K-1, C)
    history or None (zero left-pad).  The K products are added one after
    another in x's dtype, as the JAX ``sum`` does.  Returns (silu(y),
    new_cache)."""
    K = w.shape[0]
    S = x.shape[1]
    if cache is None:
        cache = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([cache, x], dim=1)
    y = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i].to(x.dtype)
    return F.silu(y), xp[:, -(K - 1):]


def _softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _proj_conv(cfg, p, x, conv_cache=None):
    """in-proj + causal conv + activations; shared by seq and step paths."""
    s = cfg.ssm
    d_in, nheads, gn = dims(cfg)
    z = torch.einsum("bsd,de->bse", x, p["wz"].to(x.dtype))
    xi = torch.einsum("bsd,de->bse", x, p["wx"].to(x.dtype))
    Bv = torch.einsum("bsd,dn->bsn", x, p["wB"].to(x.dtype))
    Cv = torch.einsum("bsd,dn->bsn", x, p["wC"].to(x.dtype))
    dt = torch.einsum("bsd,dh->bsh", x, p["wdt"].to(x.dtype))
    cc = conv_cache or {}
    xi, cx = _causal_conv(xi, p["conv_x"], cc.get("x"))
    Bv, cb = _causal_conv(Bv, p["conv_B"], cc.get("B"))
    Cv, ccv = _causal_conv(Cv, p["conv_C"], cc.get("C"))
    new_cache = {"x": cx, "B": cb, "C": ccv}
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    xh = xi.reshape(*xi.shape[:2], nheads, s.head_dim)
    # n_groups == 1 throughout the configs: the group mean is a reshape
    Bv = Bv.reshape(*Bv.shape[:2], s.n_groups, s.d_state).mean(dim=2)
    Cv = Cv.reshape(*Cv.shape[:2], s.n_groups, s.d_state).mean(dim=2)
    return z, xh, Bv, Cv, dt, new_cache


def ssd_chunked(xh, Bv, Cv, dt, A, state0=None, *, impl=None):
    """SSD over the whole sequence.  xh: (B,S,H,hd); Bv/Cv: (B,S,N); dt:
    (B,S,H) f32; A: (H,) f32 negative.  Returns (y in xh's dtype,
    final_state (B,H,hd,N) f32).  The JAX function of this name scans
    chunks of ``chunk`` steps; the kernel here runs the recurrence, so the
    chunk length is no argument."""
    return ops.ssd_scan(xh, Bv, Cv, dt, A, state0, impl=impl)


def apply_ssm(cfg, p, x, *, impl=None):
    """Full-sequence SSD block.  x: (B, S, D) -> (B, S, D)."""
    d_in, _, _ = dims(cfg)
    z, xh, Bv, Cv, dt, _ = _proj_conv(cfg, p, x)
    A = -torch.exp(p["A_log"].to(torch.float32))
    y, _ = ssd_chunked(xh, Bv, Cv, dt, A, impl=impl)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(*y.shape[:2], d_in)
    y = rmsnorm(y * F.silu(z), p["gnorm"], cfg.norm_eps)
    return torch.einsum("bse,ed->bsd", y, p["wo"].to(x.dtype))


def ssm_state_shape(cfg, batch: int, dtype=torch.float32):
    s = cfg.ssm
    d_in, nheads, gn = dims(cfg)
    K = s.conv_kernel
    return {"state": ((batch, nheads, s.head_dim, s.d_state), dtype),
            "conv_x": ((batch, K - 1, d_in), torch.bfloat16),
            "conv_B": ((batch, K - 1, gn), torch.bfloat16),
            "conv_C": ((batch, K - 1, gn), torch.bfloat16)}


def init_ssm_state(cfg, batch: int, device=None):
    return {k: torch.zeros(shp, dtype=dt, device=device)
            for k, (shp, dt) in ssm_state_shape(cfg, batch).items()}


def apply_ssm_decode(cfg, p, x, st):
    """One-token recurrent step.  x: (B, 1, D).  The state ``st`` is
    updated in place and returned."""
    d_in, _, _ = dims(cfg)
    conv_cache = {"x": st["conv_x"].to(x.dtype),
                  "B": st["conv_B"].to(x.dtype),
                  "C": st["conv_C"].to(x.dtype)}
    z, xh, Bv, Cv, dt, new_conv = _proj_conv(cfg, p, x, conv_cache)
    A = -torch.exp(p["A_log"].to(torch.float32))
    f32 = torch.float32
    dA = torch.exp(dt[:, 0] * A)                          # (B, H)
    state = st["state"] * dA[:, :, None, None] + torch.einsum(
        "bh,bhd,bn->bhdn", dt[:, 0], xh[:, 0].to(f32), Bv[:, 0].to(f32))
    y = torch.einsum("bn,bhdn->bhd", Cv[:, 0].to(f32), state)
    y = y + p["D"].to(f32)[None, :, None] * xh[:, 0].to(f32)
    y = y.reshape(x.shape[0], 1, d_in).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["gnorm"], cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, p["wo"].to(x.dtype))
    st["state"].copy_(state)
    st["conv_x"].copy_(new_conv["x"])
    st["conv_B"].copy_(new_conv["B"])
    st["conv_C"].copy_(new_conv["C"])
    return out, st
