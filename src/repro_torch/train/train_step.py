"""Train and serve steps (a port of ``repro.train.train_step``).

PyTorch runs eagerly, so each ``build_*`` returns a plain function, which
runs the hand-written kernels on CUDA tensors.  The JAX steps are jitted
under a sharding policy; these have none (the policy is ``ROADMAP.md``
queue 1 item 8).  The training steps take gradients with autograd: the
kernels' forward, the plain chunked functions' backward
(:mod:`repro_torch.kernels.ops`).
"""
from __future__ import annotations

import torch

from repro_torch.models import api
from repro_torch.train.optimizer import Optimizer, clip_by_global_norm
from repro_torch.tree import leaves, tree_map

# the profiler's label of an optimizer update
OPTIMIZER = "optimizer"


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
    position's logits of a full-sequence forward over batch["tokens"]."""

    @torch.inference_mode()
    def step(params, batch):
        logits, _ = api.forward(cfg, params, batch["tokens"])
        return logits[:, -1:].argmax(dim=-1)

    return step


def build_serve_step(cfg):
    """One decode step: (params, state, tokens) -> (next_tokens, state).
    A decode step runs no kernel of the port (see ``lm.decode_step``)."""

    @torch.inference_mode()
    def step(params, state, tokens):
        logits, state = api.decode_step(cfg, params, state, tokens)
        return logits.argmax(dim=-1), state

    return step
