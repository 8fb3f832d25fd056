"""Mamba2 (SSD, state-space duality) block (a port of ``repro.models.ssm``).

The full-sequence path (every prefill and every training forward) runs
the hand-written SSD scan through :func:`repro_torch.kernels.ops.ssd_scan`,
which returns y and the final state: the JAX model names that kernel as
the "Pallas twin" of its chunked scan but never calls it.  The JAX model
trains through its chunked scan, so the kernel's gradient is that of
:func:`ssd_chunked_plain`, the port of that scan, recomputed in the
backward.  Decode is the one-token recurrence.
"""
from __future__ import annotations

import functools

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
        "wz": mk((d, d_in), ("embed", "ssm_inner")),
        "wx": mk((d, d_in), ("embed", "ssm_inner")),
        "wB": mk((d, gn), ("embed", None)),
        "wC": mk((d, gn), ("embed", None)),
        "wdt": mk((d, nheads), ("embed", "heads")),
        "conv_x": mk((s.conv_kernel, d_in), (None, "ssm_inner"), 0.1),
        "conv_B": mk((s.conv_kernel, gn), (None, None), 0.1),
        "conv_C": mk((s.conv_kernel, gn), (None, None), 0.1),
        "A_log": mk((nheads,), ("heads",), "zeros"),
        "D": mk((nheads,), ("heads",), "ones"),
        "dt_bias": mk((nheads,), ("heads",), "zeros"),
        "gnorm": mk((d_in,), ("ssm_inner",), "zeros"),
        "wo": mk((d_in, d), ("ssm_inner", "embed")),
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


def ssd_chunked(xh, Bv, Cv, dt, A, state0=None, *, impl=None,
                chunk: int = 256):
    """SSD over the whole sequence.  xh: (B,S,H,hd); Bv/Cv: (B,S,N); dt:
    (B,S,H) f32; A: (H,) f32 negative.  Returns (y in xh's dtype,
    final_state (B,H,hd,N) f32).  The kernel picks its own chunk length;
    ``chunk`` is that of :func:`ssd_chunked_plain`, whose gradient y
    takes on the kernel path."""
    return ops.ssd_scan(xh, Bv, Cv, dt, A, state0, impl=impl,
                        backward=functools.partial(_plain_scan, chunk=chunk))


def _plain_scan(xh, Bv, Cv, dt, A, state0, *, chunk):
    return ssd_chunked_plain(xh, Bv, Cv, dt, A, chunk, state0)


def ssd_chunked_plain(xh, Bv, Cv, dt, A, chunk: int, state0=None):
    """The JAX package's chunked SSD (``repro.models.ssm.ssd_chunked``) in
    plain torch, differentiable.  xh: (B,S,H,hd); Bv/Cv: (B,S,N); dt:
    (B,S,H) f32; A: (H,) f32 negative; S a multiple of ``chunk``.  Returns
    (y in xh's dtype, final_state (B,H,hd,N) f32).  Its values are JAX's;
    its gradient stays finite where the masked half of a chunk's decay
    overflows, which makes JAX's NaN.  Unlike JAX's scan body, a chunk
    is not checkpointed: both callers already recompute the whole scan in
    the backward (the kernel's ``SSDScanFn``, and the layer group's remat
    on the plain path), and a second recompute a chunk nearly doubled a
    mamba2-370m training step on the card (``PERF.md`` §6)."""
    Bsz, S, H, hd = xh.shape
    N = Bv.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    C_n = S // chunk
    f32 = torch.float32
    xc = xh.reshape(Bsz, C_n, chunk, H, hd)
    bc = Bv.reshape(Bsz, C_n, chunk, N)
    cc = Cv.reshape(Bsz, C_n, chunk, N)
    dc = dt.reshape(Bsz, C_n, chunk, H)
    state = (torch.zeros((Bsz, H, hd, N), dtype=f32, device=xh.device)
             if state0 is None else state0)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))[None, :, :, None]

    def body(state, x_c, b_c, c_c, dt_c):
        dA = dt_c * A                              # (B,L,H) negative
        seg = torch.cumsum(dA, dim=1)
        # inter-chunk: y_i += C_i . state * exp(seg_i)
        y_inter = torch.einsum("bln,bhdn,blh->blhd", c_c.to(f32), state,
                               torch.exp(seg))
        # intra-chunk: scores_ij = (C_i.B_j) exp(seg_i - seg_j) dt_j, j<=i
        cb = torch.einsum("bin,bjn->bij", c_c.to(f32), b_c.to(f32))
        # exp of -inf above the diagonal, not of seg_i - seg_j > 0: JAX
        # takes exp of both and masks after, and over a 256-step chunk the
        # masked exponent passes 88, so exp overflows and its gradient is
        # 0 * inf = NaN; the unmasked values are the same
        decay = torch.exp(torch.where(mask, seg[:, :, None, :]
                                      - seg[:, None, :, :], -torch.inf))
        m = torch.where(mask, decay * dt_c[:, None], 0.0)   # (B,i,j,H)
        y_intra = torch.einsum("bij,bijh,bjhd->bihd", cb, m, x_c.to(f32))
        # state update
        w = torch.exp(seg[:, -1:, :] - seg) * dt_c          # (B,L,H)
        s_new = (state * torch.exp(seg[:, -1])[:, :, None, None]
                 + torch.einsum("blh,blhd,bln->bhdn", w, x_c.to(f32),
                                b_c.to(f32)))
        return s_new, (y_inter + y_intra).to(xh.dtype)

    ys = []
    for ci in range(C_n):
        state, y = body(state, xc[:, ci], bc[:, ci], cc[:, ci], dc[:, ci])
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(Bsz, S, H, hd), state


def apply_ssm(cfg, p, x, *, impl=None):
    """Full-sequence SSD block.  x: (B, S, D) -> (B, S, D)."""
    d_in, _, _ = dims(cfg)
    z, xh, Bv, Cv, dt, _ = _proj_conv(cfg, p, x)
    A = -torch.exp(p["A_log"].to(torch.float32))
    y, _ = ssd_chunked(xh, Bv, Cv, dt, A, impl=impl,
                       chunk=min(cfg.ssm.chunk, xh.shape[1]))
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
