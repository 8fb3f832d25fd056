"""Shared building blocks: parameter factory, norms, RoPE, MLP (a port of
``repro.models.common``).

Models are functional: a parameter tree (nested dicts of tensors) plus
apply functions.  The same build code produces either initialized
tensors, the tree of shapes or the tree of logical axes (for
sharding), so the three always match.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


class Mk:
    """Parameter factory, called as JAX's is: ``mk(shape, axes, scale)``
    with one logical axis (or None) a dimension.  ``mode="init"`` (the
    default with a ``torch.Generator``) draws tensors on the generator's
    device, ``"shapes"`` (the default without one) returns the shape and
    ``"axes"`` the logical axes, so the three trees always match.  The
    scales are the JAX ``Mk``'s: ``fan_in`` is normal with std
    ``1/sqrt(shape[-2])`` (``shape[0]`` for 1-D), ``zeros``, ``ones``, or a
    number times a standard normal.  torch's generator does not give
    JAX's numbers: the tests carry JAX's parameters across instead."""

    MODES = ("init", "shapes", "axes")

    def __init__(self, generator=None, dtype=torch.float32, *, mode=None):
        self.generator = generator
        self.dtype = dtype
        self.mode = mode or ("shapes" if generator is None else "init")
        if self.mode not in self.MODES:
            raise ValueError(f"Mk mode {self.mode!r} not in {self.MODES}")
        if self.mode == "init" and generator is None:
            raise ValueError("Mk(mode='init') needs a generator")

    def __call__(self, shape, axes, scale="fan_in"):
        shape, axes = tuple(shape), tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} and logical axes {axes}")
        if self.mode == "axes":
            return axes
        if self.mode == "shapes":
            return shape
        dev = self.generator.device
        if scale == "zeros":
            return torch.zeros(shape, dtype=self.dtype, device=dev)
        if scale == "ones":
            return torch.ones(shape, dtype=self.dtype, device=dev)
        if scale == "fan_in":
            fan = shape[-2] if len(shape) >= 2 else shape[0]
            scale = 1.0 / math.sqrt(fan)
        out = torch.randn(shape, generator=self.generator, dtype=self.dtype,
                          device=dev)
        return out.mul_(float(scale))


def rmsnorm(x, w, eps=1e-5):
    """RMS norm in f32, scaled by ``(1 + w)``, back in x's dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w)).to(dt)


def rope_angles(positions, head_dim: int, theta: float):
    """positions: int[...]; returns f32 (cos, sin) of shape
    [..., head_dim//2]."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: [..., seq, heads, head_dim]; cos/sin: [..., seq, head_dim//2].
    The products promote to f32 before the cast back to x's dtype."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def build_mlp(cfg, mk):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.gated_mlp:
        return {"wi": mk((d, 2 * f), ("embed", "ff")),
                "wo": mk((f, d), ("ff", "embed"))}
    return {"wi": mk((d, f), ("embed", "ff")),
            "wo": mk((f, d), ("ff", "embed"))}


def apply_mlp(cfg, p, x):
    """SwiGLU (gated) or GELU MLP.  ``jax.nn.gelu`` is the tanh
    approximation by default, so this one is too."""
    h = torch.einsum("bsd,df->bsf", x, p["wi"].to(x.dtype))
    if cfg.gated_mlp:
        g, u = h.chunk(2, dim=-1)
        h = F.silu(g) * u
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, p["wo"].to(x.dtype))


def cross_entropy(logits, labels):
    """Mean token CE in f32; logits (B,S,V), labels int (B,S); labels
    below 0 are ignored."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.clamp(min=0)[..., None].long())[..., 0]
    mask = (labels >= 0).to(torch.float32)
    loss = (lse - ll) * mask
    return loss.sum() / torch.clamp_min(mask.sum(), 1.0)
