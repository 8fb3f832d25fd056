"""Optimizers on tensor trees: AdamW and factored Adafactor (a port of
``repro.train.optimizer``).

Functional, as in the JAX package: ``opt.init(params) -> state``;
``opt.update(grads, state, params) -> (new_params, new_state)``, with new
tensors out (nothing is updated in place).  The step counter is a 0-d
int32 tensor on the parameters' device, as JAX's is an int32 scalar, so
a checkpoint holds the same arrays in both packages.
``opt.state_logical_axes(param_axes)`` gives the state's logical axes
from the parameters' (``api.param_logical_axes``), as JAX's does, for
``train_step.opt_state_shardings``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.tree import (leaves, map_axes, tree_flatten, tree_map,
                              tree_unflatten)


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    g = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(g, 1e-9), 1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), grads), g


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable
    state_logical_axes: Callable  # (param_axes_tree) -> state axes tree


def warmup_cosine(step, base_lr, warmup=200, total=10_000):
    step = step.to(torch.float32)
    warm = base_lr * step / warmup
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = base_lr * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)


def _count(params):
    dev = leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


# ------------------------------------------------------------------ AdamW --

def make_adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1,
               schedule=warmup_cosine):
    def init(params):
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params),
                "count": _count(params)}

    def update(grads, state, params):
        c = state["count"] + 1
        lr_t = schedule(c, lr)
        cf = c.to(torch.float32)
        bc1 = 1 - b1 ** cf
        bc2 = 1 - b2 ** cf
        flat_p, td = tree_flatten(params)
        new_p, new_m, new_v = [], [], []
        for g, m, v, p in zip(leaves(grads), leaves(state["m"]),
                              leaves(state["v"]), flat_p):
            g = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * p
            new_p.append((p - lr_t * u).to(p.dtype))
            new_m.append(m)
            new_v.append(v)
        return tree_unflatten(td, new_p), {
            "m": tree_unflatten(td, new_m), "v": tree_unflatten(td, new_v),
            "count": c}

    def state_axes(param_axes):
        return {"m": param_axes, "v": param_axes, "count": ()}

    return Optimizer(init, update, state_axes)


# -------------------------------------------------------------- Adafactor --

def _factored(shape) -> bool:
    return len(shape) >= 2


def make_adafactor(lr=1e-3, decay=0.8, eps=1e-30, clip_thresh=1.0,
                   schedule=warmup_cosine):
    """Factored second moment (Shazeer & Stern); no momentum; RMS
    clipping.  Row/col stats factor the last two axes; leading (stack)
    axes are kept."""

    def init(params):
        def st(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)}
        flat, td = tree_flatten(params)
        return {"s": tree_unflatten(td, [st(p) for p in flat]),
                "count": _count(params)}

    def update(grads, state, params):
        c = state["count"] + 1
        lr_t = schedule(c, lr)
        beta = 1.0 - c.to(torch.float32) ** -decay

        def upd(g, s, p):
            g = g.to(torch.float32)
            g2 = g * g + eps
            if _factored(p.shape):
                vr = beta * s["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(-2)
                # u = g / sqrt(vr (x) vc / mean(vr))   (factored 2nd moment)
                u = g * torch.rsqrt(
                    (vr[..., None] * vc[..., None, :])
                    / torch.clamp_min(vr.mean(-1, keepdim=True)[..., None],
                                      eps)
                    + eps)
                ns = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v + eps)
                ns = {"v": v}
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp_min(rms / clip_thresh, 1.0)
            return (p - lr_t * u).to(p.dtype), ns

        flat_p, td = tree_flatten(params)
        flat_g = leaves(grads)
        # the state's per-leaf dicts are subtrees: split at the params'
        # leaves, not at the state's own
        flat_s = _subtrees(state["s"], td)
        new_p, new_s = [], []
        for g, s, p in zip(flat_g, flat_s, flat_p):
            np_, ns_ = upd(g, s, p)
            new_p.append(np_)
            new_s.append(ns_)
        return (tree_unflatten(td, new_p),
                {"s": tree_unflatten(td, new_s), "count": c})

    def state_axes(param_axes):
        def st(ax):
            ax = tuple(ax)
            if len(ax) >= 2:
                return {"vr": ax[:-1], "vc": ax[:-2] + ax[-1:]}
            return {"v": ax}
        return {"s": map_axes(st, param_axes), "count": ()}

    return Optimizer(init, update, state_axes)


def _subtrees(tree, td):
    """The subtrees of ``tree`` at the leaf positions of the structure
    ``td`` (``flatten_up_to``)."""
    if td.kind == "leaf":
        return [tree]
    items = ([tree[k] for k in td.keys] if td.kind == "dict"
             else list(tree))
    out = []
    for item, child in zip(items, td.children):
        out += _subtrees(item, child)
    return out


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return make_adamw(**kw)
    if name == "adafactor":
        return make_adafactor(**kw)
    raise ValueError(name)
