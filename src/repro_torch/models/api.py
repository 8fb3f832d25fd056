"""Family-dispatching model API (a port of ``repro.models.api``).  The
decoder-only LM (``lm``) serves every family but ``encdec``, whose model
(``models/encdec.py``) is not ported yet."""
from __future__ import annotations

import torch

from repro_torch.models import lm


def _mod(cfg):
    if cfg.family == "encdec":
        raise NotImplementedError(
            "not ported yet: the encoder-decoder (models/encdec.py) comes "
            "with ROADMAP queue 1 item 6")
    return lm


def init_params(cfg, generator=None, dtype=torch.float32, device=None):
    return _mod(cfg).init_params(cfg, generator, dtype, device)


def param_shapes(cfg):
    return _mod(cfg).param_shapes(cfg)


def forward(cfg, params, tokens, **kw):
    return _mod(cfg).forward(cfg, params, tokens, **kw)


def loss_fn(cfg, params, batch, **kw):
    return _mod(cfg).loss_fn(cfg, params, batch, **kw)


def init_decode_state(cfg, params, batch, seq, **kw):
    return _mod(cfg).init_decode_state(cfg, params, batch, seq, **kw)


def decode_step(cfg, params, state, tokens, **kw):
    return _mod(cfg).decode_step(cfg, params, state, tokens, **kw)


def decode_cache_shape(cfg, batch, seq):
    return _mod(cfg).decode_cache_shape(cfg, batch, seq)
