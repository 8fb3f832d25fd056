"""Gradient compression with error feedback (a port of
``repro.train.grad_compress``).

Block-wise int8 quantization with an error-feedback residual: the
quantization error is carried to the next step.  The arithmetic keeps the
JAX package's f32 operation order (``scale = max|b| / 127``, then
``round(b / max(scale, 1e-12))``, half to even in both), so codes, scales
and residuals are bit-equal to the JAX package's on the same input.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.tree import tree_flatten, tree_unflatten, leaves


def _blockify(x, block):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, block), pad


def compress(g, *, block: int = 256):
    """g: float tensor -> (int8 codes (nblocks, block), f32 per-block
    scales (nblocks,))."""
    b, _ = _blockify(g.to(torch.float32), block)
    scale = b.abs().amax(dim=1, keepdim=True) / 127.0
    codes = torch.round(b / torch.clamp_min(scale, 1e-12)).to(torch.int8)
    return codes, scale[:, 0]


def decompress(codes, scale, shape, *, block: int = 256):
    flat = (codes.to(torch.float32) * scale[:, None]).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def compress_with_feedback(g, residual, *, block: int = 256):
    """Returns (codes, scale, new_residual): the residual carries what int8
    could not represent into the next step (error feedback)."""
    corrected = g.to(torch.float32) + residual
    codes, scale = compress(corrected, block=block)
    approx = decompress(codes, scale, g.shape, block=block)
    return codes, scale, corrected - approx


def init_residuals(params):
    flat, td = tree_flatten(params)
    return tree_unflatten(td, [torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device) for p in flat])


def compressed_grads(grads, residuals, *, block: int = 256):
    """Quantize and dequantize every gradient leaf with error feedback:
    the wire format is int8 plus one f32 scale per ``block`` values.
    Returns (dequantized grads, new residuals)."""
    flat_g, td = tree_flatten(grads)
    flat_r, td_r = tree_flatten(residuals)
    if td_r != td:
        raise ValueError("residuals do not have the gradients' structure")
    new_g, new_r = [], []
    for g, r in zip(flat_g, flat_r):
        codes, scale, nr = compress_with_feedback(g, r, block=block)
        new_g.append(decompress(codes, scale, g.shape, block=block))
        new_r.append(nr)
    return tree_unflatten(td, new_g), tree_unflatten(td, new_r)


def wire_bytes(params, *, block: int = 256) -> tuple[int, int]:
    """(compressed, uncompressed-f32) bytes per full gradient exchange."""
    comp = unc = 0
    for p in leaves(params):
        n = p.numel()
        comp += n + (n + block - 1) // block * 4
        unc += n * 4
    return comp, unc
