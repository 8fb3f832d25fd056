"""Encoder-decoder, whisper's family (a port of ``repro.models.encdec``).

The audio front end is a stub, as in the JAX package: ``modality`` holds
precomputed mel-frame features (B, M, mel), cast to ``ACT_DTYPE`` and
projected to the model width, plus a learned position table.  The encoder
runs its groups with non-causal self-attention (rope on, as JAX's default
``rope_theta`` has it) and ends in a norm; the decoder's groups are
causal self-attention, cross-attention over the encoder's output and an
MLP.  Cross-attention's K and V are computed once at encode time and read
by every decode step (``init_decode_state(modality=)``).

Parameters keep the JAX tree: ``embed``, ``mod_proj``, ``enc_pos``,
``enc_groups`` and ``enc_norm``, ``groups`` (the decoder's),
``final_norm``, and ``lm_head`` when untied.  Groups run in Python loops,
each recomputed in the backward under autograd (``lm.run_groups``).  The
decode state is ``lm``'s, updated in place.
"""
from __future__ import annotations

import torch

from repro_torch.models import blocks as B
from repro_torch.models import lm
from repro_torch.models.common import Mk, cross_entropy, rmsnorm


def _enc_pattern(cfg):
    return [("attn", "mlp")], cfg.encoder_layers


def _dec_pattern(cfg):
    return [("attn", "cross", "mlp")], cfg.num_layers


def build(cfg, mk):
    d, v = cfg.d_model, cfg.vocab_size
    enc_pat, ge = _enc_pattern(cfg)
    dec_pat, gd = _dec_pattern(cfg)
    p = {"embed": mk((v, d), ("vocab", None), 0.02),
         "mod_proj": mk((cfg.modality_dim, d), (None, None)),
         "enc_pos": mk((cfg.num_modality_tokens, d), (None, None), 0.02),
         "enc_groups": B.build_group(cfg, lm.StackedMk(mk, ge), enc_pat),
         "enc_norm": mk((d,), (None,), "zeros"),
         "groups": B.build_group(cfg, lm.StackedMk(mk, gd), dec_pat),
         "final_norm": mk((d,), (None,), "zeros")}
    if not cfg.tie_embeddings:
        p["lm_head"] = mk((d, v), (None, "vocab"))
    return p


def init_params(cfg, generator=None, dtype=torch.float32, device=None):
    """As ``lm.init_params``: drawn on ``device`` (the card unless the
    caller asks for the CPU) from ``generator`` (seed 0 if None)."""
    return lm.init_params(cfg, generator, dtype, device, build_fn=build)


def param_shapes(cfg):
    """The parameter tree with shape tuples for leaves."""
    return build(cfg, Mk())


def logical_axes(cfg):
    """The parameter tree with logical-axis tuples for leaves."""
    return build(cfg, Mk(mode="axes"))


def encode(cfg, params, modality, *, impl=None):
    """(B, M, mel) features -> the encoder's output (B, M, D), normed."""
    x = lm.project_modality(params, modality)
    x = x + params["enc_pos"].to(lm.ACT_DTYPE)[None]
    x, _ = lm.run_groups(cfg, params["enc_groups"], x, causal=False,
                         impl=impl)
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def forward_hidden(cfg, params, tokens, *, modality, impl=None):
    """tokens: (B, S) int, modality: (B, M, mel) -> (the decoder's final
    hidden (B, S, D) before the head, aux f32 0.0)."""
    mem = encode(cfg, params, modality, impl=impl)
    return lm.run_groups(cfg, params["groups"], lm._embed(params, tokens),
                         mem=mem, impl=impl)


def forward(cfg, params, tokens, *, modality, impl=None):
    """tokens: (B, S) int -> (logits (B, S, V), aux f32 0.0)."""
    x, aux = forward_hidden(cfg, params, tokens, modality=modality,
                            impl=impl)
    return lm._head(cfg, params, x), aux


def loss_fn(cfg, params, batch, *, aux_coef=None, impl=None):
    """Mean token cross-entropy of the decoder over ``batch["tokens"]``
    against ``batch["labels"]``, given ``batch["modality"]``."""
    logits, _ = forward(cfg, params, batch["tokens"],
                        modality=batch["modality"], impl=impl)
    return cross_entropy(logits, batch["labels"])


@torch.inference_mode()
def init_decode_state(cfg, params, batch: int, seq: int, *, modality=None):
    """Zeros; with ``modality`` the cross caches filled from the encoder's
    output (``lm._precompute_cross``)."""
    state = lm.zero_state(lm.decode_cache_shape(cfg, batch, seq),
                          params["embed"].device)
    if modality is not None:
        lm._precompute_cross(cfg, params, encode(cfg, params, modality),
                             state["caches"])
    return state


# The decoder's decode state and step are ``lm``'s: ``blocks.group_pattern``
# gives the encdec family the decoder's pattern, and there is no ``pre``
# layer.  Its caches: self-attention (B, seq, kv, hd) and cross-attention
# (B, M, kv, hd), stacked over the decoder's groups.
decode_cache_shape = lm.decode_cache_shape
decode_step = lm.decode_step
