"""Train and serve steps (a port of ``repro.train.train_step``).

PyTorch runs eagerly, so each ``build_*`` returns a plain function, which
runs the hand-written kernels on CUDA tensors.  The JAX steps are jitted
with the shardings of a policy; these are not: under a policy
(``repro_torch.sharding.set_policy``) only the MoE dispatch changes
(``models/moe.py``).  The sharding functions (:func:`param_shardings`,
:func:`opt_state_shardings`, :func:`batch_shardings`,
:func:`decode_state_shardings`) give JAX's shardings from shapes, with no
tensor allocated.  The training steps take gradients with autograd: the
kernels' forward, the plain chunked functions' backward
(:mod:`repro_torch.kernels.ops`).
"""
from __future__ import annotations

import torch

from repro_torch.models import api
from repro_torch.sharding.policy import NamedSharding, P
from repro_torch.train.optimizer import Optimizer, clip_by_global_norm
from repro_torch.tree import leaves, map_axes, tree_map

# the profiler's label of an optimizer update
OPTIMIZER = "optimizer"


def _shape(leaf) -> tuple:
    """The shape of a tensor, a (shape, dtype) pair (``decode_cache_shape``'s
    leaves) or a shape tuple (``api.param_shapes``')."""
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    if len(leaf) == 2 and isinstance(leaf[1], torch.dtype):
        return tuple(leaf[0])
    return tuple(leaf)


def _divisible_sharding(policy, ax, shape) -> NamedSharding:
    """Resolve logical axes to a NamedSharding, replicating any dimension
    whose size its mesh axes do not divide (jit argument shardings must
    divide)."""
    spec = policy.resolve(tuple(ax))
    fixed = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        n = 1
        for a in P.names(entry):
            n *= policy.mesh.shape[a]
        fixed.append(entry if entry is not None and dim % n == 0 else None)
    return NamedSharding(policy.mesh, P(*fixed))


def _meta(shapes):
    """A tree of shape tuples as meta tensors (no storage)."""
    return map_axes(lambda s: torch.empty(s, device="meta"), shapes)


def param_shardings(cfg, policy, pshapes=None):
    axes = api.param_logical_axes(cfg)
    if pshapes is None:
        pshapes = api.param_shapes(cfg)
    return map_axes(lambda ax, sd: _divisible_sharding(policy, ax,
                                                       _shape(sd)),
                    axes, pshapes)


def opt_state_shardings(cfg, policy, opt: Optimizer, oshapes=None):
    st_axes = opt.state_logical_axes(api.param_logical_axes(cfg))
    if oshapes is None:
        oshapes = opt.init(_meta(api.param_shapes(cfg)))
    return map_axes(lambda ax, sd: _divisible_sharding(policy, ax,
                                                       _shape(sd)),
                    st_axes, oshapes)


def batch_shardings(cfg, policy, spec_shapes):
    out = {}
    for k, v in spec_shapes.items():
        if k in ("tokens", "labels"):
            s = "seq_sharded" if _shape(v)[-1] > 1 else None
            out[k] = policy.sharding(("batch", s))
        elif k == "modality":
            out[k] = policy.sharding(("batch", None, None))
        else:
            out[k] = NamedSharding(policy.mesh, P())
    return out


def cache_logical_axes(cfg, state_shapes):
    """Logical axes of the decode state (``api.decode_cache_shape``), by
    leaf name and rank."""
    def leaf_axes(name, sd):
        nd = len(_shape(sd))
        if name in ("k", "v"):          # (G?, B, T, KVe, hd)
            ax = ("kv_batch", "kv_seq", "kv_heads", None)
        elif name in ("latent", "k_rope"):
            ax = ("kv_batch", "kv_seq", None)
        elif name == "state":           # ssm (B, H, hd, N)
            ax = ("kv_batch", "heads", None, None)
        elif name.startswith("conv_x"):
            ax = ("kv_batch", None, "ssm_inner")
        elif name.startswith("conv"):
            ax = ("kv_batch", None, None)
        elif name == "pos":
            return ()
        else:
            ax = (None,) * nd
        if nd == len(ax) + 1:           # group-stacked
            ax = ("stack",) + ax
        if len(ax) != nd:
            raise ValueError(f"decode state leaf {name!r} of shape "
                             f"{_shape(sd)} has no axes of rank {nd}")
        return ax

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return leaf_axes(name, tree)
    return walk(state_shapes, "")


def decode_state_shardings(cfg, policy, state_shapes):
    axes = cache_logical_axes(cfg, state_shapes)
    return map_axes(lambda ax, sd: _divisible_sharding(policy, ax,
                                                       _shape(sd)),
                    axes, state_shapes)


def _loss_and_grads(cfg, params, batch, microbatches: int, *, impl=None):
    """(loss, grads), with ``microbatches`` > 1 accumulating f32 gradients
    over equal slices of the batch (the activation live-set divided by M
    at the cost of an f32 gradient accumulator).  The gradients are
    taken with respect to ``params``' leaves, which need not require
    grad."""
    flat = leaves(params)

    def grads_of(mb):
        ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss = api.loss_fn(cfg, ps, mb, impl=impl)
            gs = torch.autograd.grad(loss, leaves(ps))
        it = iter(gs)
        return loss.detach(), tree_map(lambda _: next(it), params)

    if microbatches == 1:
        return grads_of(batch)
    for k, x in batch.items():
        if x.shape[0] % microbatches:
            raise ValueError(f"batch[{k!r}] of {x.shape[0]} rows does not "
                             f"split into {microbatches} microbatches")
    loss_sum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    for i in range(microbatches):
        mb = {k: x.reshape((microbatches, x.shape[0] // microbatches)
                           + tuple(x.shape[1:]))[i]
              for k, x in batch.items()}
        loss, g = grads_of(mb)
        loss_sum = loss_sum + loss
        acc = tree_map(torch.add, acc, g)
        del g
    return loss_sum / microbatches, tree_map(lambda g: g / microbatches,
                                             acc)


def build_train_step(cfg, opt: Optimizer, *, max_grad_norm: float = 1.0,
                     microbatches: int = 1):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics)."""

    def step(params, opt_state, batch):
        loss, grads = _loss_and_grads(cfg, params, batch, microbatches)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        with torch.no_grad(), torch.profiler.record_function(OPTIMIZER):
            new_params, new_state = opt.update(grads, opt_state, params)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "step": new_state["count"]}
        return new_params, new_state, metrics

    return step


def build_grad_step(cfg, *, max_grad_norm: float = 1.0,
                    microbatches: int = 1, impl=None):
    """The compute half of :func:`build_train_step`: step(params, batch)
    -> (grads, metrics), no optimizer apply, for sync layers that install
    updates elsewhere (the §6 parameter server pushes these clipped
    gradients through the fabric; see :mod:`repro_torch.analytics`).
    ``impl`` picks the kernels' dispatch (None: the kernels on the card;
    "plain": the plain path the gradient check holds them to)."""

    def step(params, batch):
        loss, grads = _loss_and_grads(cfg, params, batch, microbatches,
                                      impl=impl)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        return grads, {"loss": loss, "grad_norm": gnorm}

    return step


def build_prefill_step(cfg):
    """step(params, batch) -> next tokens (B, 1): the argmax of the last
    position's logits of a full-sequence forward over batch["tokens"]
    (with batch["modality"], where the model takes one)."""

    @torch.inference_mode()
    def step(params, batch):
        logits, _ = api.forward(cfg, params, batch["tokens"],
                                modality=batch.get("modality"))
        return logits[:, -1:].argmax(dim=-1)

    return step


def build_serve_step(cfg):
    """One decode step: (params, state, tokens) -> (next_tokens, state).
    A decode step runs no kernel of the port but under a sharding policy
    (see ``lm.decode_step``)."""

    @torch.inference_mode()
    def step(params, state, tokens):
        logits, state = api.decode_step(cfg, params, state, tokens)
        return logits.argmax(dim=-1), state

    return step
