"""Decoder-only causal LM, families ``dense`` and ``ssm`` (a port of
``repro.models.lm``).

Parameters keep the JAX tree: ``embed``, ``final_norm``, ``lm_head``
(untied only) and ``groups``, whose leaves are stacked over the G layer
groups.  The body loops over groups where JAX scans them.  Activations
are ``ACT_DTYPE`` (bf16), read at call time so a test can set f32.
``loss_fn`` is the training loss (the mean token cross-entropy, or its
sequence-chunked form when ``CE_CHUNK`` is set); with autograd on, each
group of the body is recomputed in the backward (JAX's remat, its
``jax.checkpoint`` of the scan body).  The decode functions run under
``torch.inference_mode()``.

The decode state is updated in place: ``decode_step`` writes the new
KV entries and SSM states into the state's tensors and returns them with
``pos`` advanced, where JAX returns a new state.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._bits import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.common import Mk, cross_entropy, rmsnorm

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


def group_views(groups, G: int) -> list:
    """The G per-group trees of a stacked tree, as views (``unbind``: one
    backward node a leaf stacks every group's gradient at once, where G
    indexings would each write a full-size gradient)."""
    if isinstance(groups, dict):
        per = {k: group_views(v, G) for k, v in groups.items()}
        return [{k: per[k][g] for k in groups} for g in range(G)]
    return list(groups.unbind(0))


# stream the cross-entropy over sequence chunks so the full (B, S, V) f32
# logits never materialize (the JAX package's memory lever; off there too)
CE_CHUNK = 0


def forward_hidden(cfg, params, tokens, *, impl=None):
    """tokens: (B, S) int -> final hidden (B, S, D), before the head.
    ``impl`` picks the kernels' dispatch (None: the kernels on the card).
    With autograd on, each group's activations are recomputed in the
    backward instead of kept (JAX's default remat)."""
    x = _embed(params, tokens)
    ckpt = torch.is_grad_enabled()
    for gp in group_views(params["groups"], num_groups(params)):
        if ckpt:
            x = checkpoint(B.apply_group, cfg, gp, x, impl=impl,
                           use_reentrant=False)
        else:
            x = B.apply_group(cfg, gp, x, impl=impl)
    return x


def forward(cfg, params, tokens, *, impl=None):
    """tokens: (B, S) int -> (logits (B, S, V), aux).  aux is the MoE
    router loss in JAX; with no MoE ported it is 0.0."""
    return _head(cfg, params, forward_hidden(cfg, params, tokens,
                                             impl=impl)), 0.0


def _chunked_ce(cfg, params, x, labels, chunk: int):
    """CE streamed over sequence chunks: per-chunk logits in f32,
    recomputed in the backward, so O(B*chunk*V) is live instead of
    O(B*S*V)."""
    S = x.shape[1]
    n = max(S // chunk, 1)
    c = S // n

    def body(xc, yc):
        logits = _head(cfg, params, xc).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, yc.clamp(min=0)[..., None].long())[..., 0]
        mask = (yc >= 0).to(torch.float32)
        return ((lse - ll) * mask).sum(), mask.sum()

    remat = torch.is_grad_enabled()
    tot = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        xc, yc = x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        t, m = (checkpoint(body, xc, yc, use_reentrant=False) if remat
                else body(xc, yc))
        tot, cnt = tot + t, cnt + m
    return tot / torch.clamp_min(cnt, 1.0)


def loss_fn(cfg, params, batch, *, impl=None):
    """Mean token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (labels < 0 ignored).  JAX adds the MoE router
    loss times its coefficient; with no MoE ported that term is 0."""
    if CE_CHUNK:
        x = forward_hidden(cfg, params, batch["tokens"], impl=impl)
        return _chunked_ce(cfg, params, x, batch["labels"], CE_CHUNK)
    logits, _ = forward(cfg, params, batch["tokens"], impl=impl)
    return cross_entropy(logits, batch["labels"])


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
