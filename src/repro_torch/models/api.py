"""Family-dispatching model API (a port of ``repro.models.api``).  The
decoder-only LM (``lm``) serves the dense, MoE (llama4, deepseek with
MLA), SSM, hybrid (jamba) and VLM (llama-3.2 vision) families;
``encdec`` serves whisper.  ``modality`` passes through as a keyword."""
from __future__ import annotations

import torch

from repro_torch.models import encdec, lm


def module(cfg):
    """The model module of ``cfg``'s family."""
    return encdec if cfg.family == "encdec" else lm


def init_params(cfg, generator=None, dtype=torch.float32, device=None):
    return module(cfg).init_params(cfg, generator, dtype, device)


def param_shapes(cfg):
    return module(cfg).param_shapes(cfg)


def param_logical_axes(cfg):
    return module(cfg).logical_axes(cfg)


def forward(cfg, params, tokens, **kw):
    return module(cfg).forward(cfg, params, tokens, **kw)


def loss_fn(cfg, params, batch, **kw):
    return module(cfg).loss_fn(cfg, params, batch, **kw)


def init_decode_state(cfg, params, batch, seq, **kw):
    return module(cfg).init_decode_state(cfg, params, batch, seq, **kw)


def decode_step(cfg, params, state, tokens, **kw):
    return module(cfg).decode_step(cfg, params, state, tokens, **kw)


def decode_cache_shape(cfg, batch, seq):
    return module(cfg).decode_cache_shape(cfg, batch, seq)
