"""Mixture-of-Experts (a port of ``repro.models.moe``'s one-device path).

With no sharding policy JAX's ``apply_moe`` runs ``_moe_reference``, the
loop in which every token goes through every expert, and one card has no
policy.  The port keeps that loop as the plain version
(:func:`_moe_reference`; decode runs it, as JAX's does) and computes the
same function on the prefill and training path by packing
(:func:`_moe_packed`): the router's rank kernel
(``kernels/radix_partition.py`` ``rank``) bins the T * top_k
assignments by expert with capacity T, so none drops (a token's top-k
experts are distinct), each expert's SwiGLU runs on its own rows only,
and the gate-weighted outputs come back to their tokens in the
reference's order of additions.  That is the stable binning of JAX's
``_radix_to_buffers`` (the paper's radix-partitioned buffers, §5.2)
with no capacity cut.  Under ``impl="plain"`` the same packing takes the
rank's plain twin, so both paths build the same rows.

JAX's RRJ dispatch (``_moe_rrj``, ``_moe_replicated``) needs a ``model``
mesh axis: it comes with ROADMAP queue 1 item 8.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def build_moe(cfg, mcfg, mk):
    d, f, e = cfg.d_model, mcfg.d_ff, mcfg.num_experts
    p = {"router": mk((d, e)), "wi": mk((e, d, 2 * f)),
         "wo": mk((e, f, d))}
    if mcfg.num_shared:
        sf = mcfg.shared_d_ff or f
        p["shared_wi"] = mk((d, 2 * sf * mcfg.num_shared))
        p["shared_wo"] = mk((sf * mcfg.num_shared, d))
    return p


def _gates(mcfg, xt, router_w):
    """xt: (T, D) -> (top-k gates (T, k) renormalized, expert ids (T, k),
    probabilities (T, E)).  Ids in descending probability; among equal
    probabilities the lower id first, as ``jax.lax.top_k`` takes them
    (``torch.topk`` does not promise an order for ties, a stable sort
    does)."""
    logits = xt.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    svals, sidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = svals[:, :mcfg.top_k], sidx[:, :mcfg.top_k]
    vals = vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)
    return vals, idx, probs


def _expert_ffn(h_in, wi, wo):
    """One expert's SwiGLU: h_in (C, D), wi (D, 2F), wo (F, D)."""
    g, u = (h_in @ wi).chunk(2, dim=-1)
    return (F.silu(g) * u) @ wo


def aux_load_balance(mcfg, xt, router_w):
    """Switch-style load-balancing loss: E * sum_e f_e * p_e, f_e the
    tokens' mean count of assignments to e, p_e their mean probability."""
    _, idx, probs = _gates(mcfg, xt, router_w)
    e = mcfg.num_experts
    f = F.one_hot(idx, e).to(torch.float32).sum(1).mean(0)
    return e * torch.sum(f * probs.mean(0))


def _moe_reference(cfg, mcfg, p, x):
    """The loop over experts: every token through every expert, ``out``
    accumulated in x's dtype in expert order 0..E-1.  Exact (no token
    dropped); the plain version of :func:`_moe_packed`."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    vals, idx, _ = _gates(mcfg, xt, p["router"])
    out = torch.zeros_like(xt)
    for e in range(mcfg.num_experts):
        w = torch.where(idx == e, vals, 0.0).sum(-1)             # (T,)
        y = _expert_ffn(xt, p["wi"][e].to(x.dtype), p["wo"][e].to(x.dtype))
        out = out + y * w[:, None].to(x.dtype)
    return out.reshape(B, S, D)


def _moe_packed(cfg, mcfg, p, x, *, impl=None):
    """:func:`_moe_reference`'s function with each expert on its own rows.

    The assignments (token t's k experts, in ascending id) are ranked by
    expert into E buckets of cap T (``ops.rank``: the kernel on the card);
    row = exclusive-cumsum(counts)[e] + rank packs them by expert in
    arrival order.  The per-expert row counts come to the host once (one
    sync a layer) to cut the packed rows.  A token's outputs are added to
    zeros in ascending expert id, the order in which the reference adds
    them, each rounded to x's dtype."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    T, k, E = xt.shape[0], mcfg.top_k, mcfg.num_experts
    vals, idx, _ = _gates(mcfg, xt, p["router"])
    idx, order = idx.sort(dim=-1)
    vals = vals.gather(-1, order)
    dest = idx.reshape(-1).to(torch.int32)                      # (A,)
    slot, _, _, counts = ops.rank(dest, E, T, impl=impl)
    ends = torch.cumsum(counts, 0)
    row = (ends - counts)[dest.long()] + slot - dest * T        # (A,) int64
    src = torch.empty_like(row)
    src[row] = torch.arange(T * k, dtype=row.dtype, device=row.device) // k
    xs = xt[src]                                                # packed
    ys, lo = [], 0
    for e, hi in enumerate(ends.tolist()):
        if hi > lo:
            ys.append(_expert_ffn(xs[lo:hi], p["wi"][e].to(x.dtype),
                                  p["wo"][e].to(x.dtype)))
        lo = hi
    y = torch.cat(ys)[row].reshape(T, k, D)
    y = y * vals[..., None].to(x.dtype)
    out = torch.zeros_like(xt)
    for j in range(k):
        out = out + y[:, j]
    return out.reshape(B, S, D)


def apply_moe(cfg, mcfg, p, x, *, decode: bool = False, impl=None):
    """x: (B, S, D) -> (y, aux loss).  Decode runs the reference loop (JAX's
    one-device decode); the full sequence the packed experts, ``impl``
    picking the rank's dispatch (None: the kernel on the card).  Shared
    experts are a dense SwiGLU added to every token."""
    xt = x.reshape(-1, x.shape[-1])
    aux = aux_load_balance(mcfg, xt, p["router"])
    y = (_moe_reference(cfg, mcfg, p, x) if decode
         else _moe_packed(cfg, mcfg, p, x, impl=impl))
    if mcfg.num_shared:
        g, u = torch.einsum("bsd,df->bsf", x, p["shared_wi"].to(
            x.dtype)).chunk(2, dim=-1)
        y = y + torch.einsum("bsf,fd->bsd", F.silu(g) * u,
                             p["shared_wo"].to(x.dtype))
    return y, aux
