"""Decoder-only causal LM, families ``dense`` and ``ssm`` (a port of
``repro.models.lm``).

Parameters keep the JAX tree: ``embed``, ``final_norm``, ``lm_head``
(untied only) and ``groups``, whose leaves are stacked over the G layer
groups.  The body loops over groups where JAX scans them.  Activations
are ``ACT_DTYPE`` (bf16), read at call time so a test can set f32.
Everything here runs under ``torch.inference_mode()``; training (the
loss, the chunked cross-entropy) comes with the training slice.

The decode state is updated in place: ``decode_step`` writes the new
KV entries and SSM states into the state's tensors and returns them with
``pos`` advanced, where JAX returns a new state.
"""
from __future__ import annotations

import torch

from repro_torch._bits import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.common import Mk, rmsnorm

ACT_DTYPE = torch.bfloat16


class StackedMk:
    def __init__(self, mk, g: int):
        self.mk, self.g = mk, g

    def __call__(self, shape, scale="fan_in"):
        return self.mk((self.g,) + tuple(shape), scale)


def build(cfg, mk):
    d, v = cfg.d_model, cfg.vocab_size
    pattern, G, pre = B.group_pattern(cfg)
    p = {"embed": mk((v, d), 0.02), "final_norm": mk((d,), "zeros")}
    if not cfg.tie_embeddings:
        p["lm_head"] = mk((d, v))
    if cfg.modality_dim or pre:
        raise B.not_ported("cross" if cfg.modality_dim else "moe")
    p["groups"] = B.build_group(cfg, StackedMk(mk, G), pattern)
    return p


def init_params(cfg, generator=None, dtype=torch.float32, device=None):
    """Random parameters drawn on ``device`` (the card unless the caller
    asks for the CPU) from ``generator`` (a ``torch.Generator`` on that
    device; seed 0 if None)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{device}")
    return build(cfg, Mk(generator, dtype))


def param_shapes(cfg):
    """The parameter tree with shape tuples for leaves."""
    return build(cfg, Mk())


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_index(tree, g: int):
    """Group ``g`` of a tree stacked over groups (views, no copy)."""
    return tree_map(lambda t: t[g], tree)


def _embed(params, tokens):
    return params["embed"][tokens].to(ACT_DTYPE)


def _head(cfg, params, x):
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("bsd,dv->bsv", x, w.to(x.dtype))


def num_groups(params) -> int:
    leaf = params["groups"]
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


@torch.inference_mode()
def forward_hidden(cfg, params, tokens, *, impl=None):
    """tokens: (B, S) int -> final hidden (B, S, D), before the head.
    ``impl`` picks the kernels' dispatch (None: the kernels on the card)."""
    x = _embed(params, tokens)
    for g in range(num_groups(params)):
        x = B.apply_group(cfg, tree_index(params["groups"], g), x,
                          impl=impl)
    return x


@torch.inference_mode()
def forward(cfg, params, tokens, *, impl=None):
    """tokens: (B, S) int -> (logits (B, S, V), aux).  aux is the MoE
    router loss in JAX; with no MoE ported it is 0.0."""
    return _head(cfg, params, forward_hidden(cfg, params, tokens,
                                             impl=impl)), 0.0


# --------------------------------------------------------------- decode ---

def decode_cache_shape(cfg, batch: int, seq: int):
    """{"caches": {block: {sublayer: {leaf: (shape, dtype)}}}, "pos": ((),
    int32)}: caches stacked over groups, raw KV heads."""
    pattern, G, pre = B.group_pattern(cfg)
    if pre:
        raise B.not_ported("moe")
    kve = max(cfg.num_kv_heads, 1)
    per_group = B.group_cache_shape(cfg, pattern, batch, seq, kve)

    def stack(leaf):
        return ((G,) + tuple(leaf[0]), leaf[1])
    caches = {b: {s: {k: stack(v) for k, v in c.items()}
                  for s, c in bv.items()} for b, bv in per_group.items()}
    return {"caches": caches, "pos": ((), torch.int32)}


@torch.inference_mode()
def init_decode_state(cfg, params, batch: int, seq: int):
    """Zeroed decode state on the parameters' device."""
    dev = params["embed"].device
    shapes = decode_cache_shape(cfg, batch, seq)
    caches = {b: {s: {k: torch.zeros(shp, dtype=dt, device=dev)
                      for k, (shp, dt) in c.items()}
                  for s, c in bv.items()}
              for b, bv in shapes["caches"].items()}
    return {"caches": caches,
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.inference_mode()
def decode_step(cfg, params, state, tokens):
    """tokens: (B, 1) int -> (logits (B, 1, V), state with pos + 1).  The
    state's caches are updated in place.  No kernel of the port runs in a
    decode step: attention against the cache is the plain chunked path."""
    pos = state["pos"]
    x = _embed(params, tokens)
    for g in range(num_groups(params)):
        x = B.apply_group_decode(cfg, tree_index(params["groups"], g), x,
                                 tree_index(state["caches"], g), pos)
    return _head(cfg, params, x), {"caches": state["caches"],
                                   "pos": pos + 1}
