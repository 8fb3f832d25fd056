"""The serving steps of ``repro.train.train_step``: prefill (the argmax of
the last position's logits) and one decode step.  PyTorch runs them
eagerly, so each ``build_*`` returns a plain function, which runs the
hand-written kernels on CUDA tensors.  The training half (loss,
gradients, optimizer) comes with the training slice."""
from __future__ import annotations

import torch

from repro_torch.models import api


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
