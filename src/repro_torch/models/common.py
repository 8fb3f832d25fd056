"""Shared building blocks: parameter factory, norms, RoPE, MLP (a port of
``repro.models.common``).

Models are functional: a parameter tree (nested dicts of tensors) plus
apply functions.  The same build code produces either initialized
tensors or the tree of shapes, so the two always match.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


class Mk:
    """Parameter factory.  With a ``torch.Generator`` it draws tensors on
    the generator's device; with ``generator=None`` it returns shapes.
    The scales are the JAX ``Mk``'s: ``fan_in`` is normal with std
    ``1/sqrt(shape[-2])`` (``shape[0]`` for 1-D), ``zeros``, ``ones``, or a
    number times a standard normal.  torch's generator does not give
    JAX's numbers: the tests carry JAX's parameters across instead."""

    def __init__(self, generator=None, dtype=torch.float32):
        self.generator = generator
        self.dtype = dtype

    def __call__(self, shape, scale="fan_in"):
        shape = tuple(shape)
        if self.generator is None:
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
        return {"wi": mk((d, 2 * f)), "wo": mk((f, d))}
    return {"wi": mk((d, f)), "wo": mk((f, d))}


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
