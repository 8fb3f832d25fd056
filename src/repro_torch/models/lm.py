"""Decoder-only causal LM, families ``dense``, ``moe``, ``ssm``,
``hybrid`` and ``vlm`` (a port of ``repro.models.lm``).

Parameters keep the JAX tree: ``embed``, ``final_norm``, ``lm_head``
(untied only), ``mod_proj`` (the VLM's projection of the modality
features to the model width), ``pre`` (deepseek's irregular dense first
layer) and ``groups``, whose leaves are stacked over the G layer groups.
A VLM's ``modality`` (B, M, modality_dim) is cast to ``ACT_DTYPE`` and
projected into the memory its cross layers attend to; without it, its
cross layers attend over the text itself, as JAX's do.  The body
loops over groups where JAX scans them.  Activations are ``ACT_DTYPE``
(bf16), read at call time so a test can set f32.  ``forward`` returns
the logits and the MoE router's load-balancing loss summed over layers
(0.0 with no MoE layer); ``loss_fn`` is the training loss (the mean
token cross-entropy, or its sequence-chunked form when ``CE_CHUNK`` is
set, plus ``router_aux_coef`` times that aux); with autograd on, each
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

    def __call__(self, shape, axes, scale="fan_in"):
        return self.mk((self.g,) + tuple(shape), ("stack",) + tuple(axes),
                       scale)


def build(cfg, mk):
    d, v = cfg.d_model, cfg.vocab_size
    pattern, G, pre = B.group_pattern(cfg)
    p = {"embed": mk((v, d), ("vocab", None), 0.02),
         "final_norm": mk((d,), (None,), "zeros")}
    if not cfg.tie_embeddings:
        p["lm_head"] = mk((d, v), (None, "vocab"))
    if cfg.modality_dim:
        p["mod_proj"] = mk((cfg.modality_dim, d), (None, None))
    if pre:  # deepseek-v2: irregular dense first layer (d_ff = cfg.d_ff)
        p["pre"] = {"s0_attn": B.build_sublayer(cfg, mk, "attn"),
                    "s1_mlp": B.build_sublayer(cfg, mk, "mlp")}
    p["groups"] = B.build_group(cfg, StackedMk(mk, G), pattern)
    return p


def init_params(cfg, generator=None, dtype=torch.float32, device=None, *,
                build_fn=None):
    """Random parameters drawn on ``device`` (the card unless the caller
    asks for the CPU) from ``generator`` (a ``torch.Generator`` on that
    device; seed 0 if None); ``build_fn`` another family's ``build``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{device}")
    return (build_fn or build)(cfg, Mk(generator, dtype))


def param_shapes(cfg):
    """The parameter tree with shape tuples for leaves."""
    return build(cfg, Mk())


def logical_axes(cfg):
    """The parameter tree with logical-axis tuples for leaves."""
    return build(cfg, Mk(mode="axes"))


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


def project_modality(params, modality):
    """(B, M, modality_dim) features -> (B, M, D) memory in ``ACT_DTYPE``:
    cast first, then projected, as JAX does."""
    return torch.einsum("bmd,de->bme", modality.to(ACT_DTYPE),
                        params["mod_proj"].to(ACT_DTYPE))


def run_groups(cfg, groups, x, *, mem=None, causal=True, impl=None):
    """x through every group of a stacked ``groups`` tree: (x, summed aux
    f32).  With autograd on, each group's activations are recomputed in
    the backward instead of kept (JAX's remat of its scan body)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ckpt = torch.is_grad_enabled()
    for gp in group_views(groups, num_groups({"groups": groups})):
        if ckpt:
            x, a = checkpoint(B.apply_group, cfg, gp, x, mem=mem,
                              causal=causal, impl=impl, use_reentrant=False)
        else:
            x, a = B.apply_group(cfg, gp, x, mem=mem, causal=causal,
                                 impl=impl)
        aux = aux + a
    return x, aux


def forward_hidden(cfg, params, tokens, *, modality=None, impl=None):
    """tokens: (B, S) int -> (final hidden (B, S, D) before the head, aux
    f32).  ``modality``: a VLM's (B, M, modality_dim) features.  ``impl``
    picks the kernels' dispatch (None: the kernels on the card).  With
    autograd on, each group is recomputed in the backward (JAX does not
    remat the ``pre`` layer either)."""
    x = _embed(params, tokens)
    mem = None
    if cfg.modality_dim and modality is not None:
        mem = project_modality(params, modality)
    if "pre" in params:
        x, _ = B.apply_sublayer(cfg, params["pre"]["s0_attn"], "attn", x,
                                impl=impl)
        x, _ = B.apply_sublayer(cfg, params["pre"]["s1_mlp"], "mlp", x,
                                impl=impl)
    return run_groups(cfg, params["groups"], x, mem=mem, impl=impl)


def forward(cfg, params, tokens, *, modality=None, impl=None):
    """tokens: (B, S) int -> (logits (B, S, V), aux): aux the MoE
    router's load-balancing loss summed over layers, an f32 scalar (0.0
    with no MoE layer)."""
    x, aux = forward_hidden(cfg, params, tokens, modality=modality,
                            impl=impl)
    return _head(cfg, params, x), aux


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


def loss_fn(cfg, params, batch, *, aux_coef=None, impl=None):
    """Mean token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (labels < 0 ignored) plus ``aux_coef`` (default
    the config's ``router_aux_coef``, 0 with no MoE) times the router's
    load-balancing loss; a VLM's features come as ``batch["modality"]``."""
    mod = batch.get("modality")
    if CE_CHUNK:
        x, aux = forward_hidden(cfg, params, batch["tokens"], modality=mod,
                                impl=impl)
        loss = _chunked_ce(cfg, params, x, batch["labels"], CE_CHUNK)
    else:
        logits, aux = forward(cfg, params, batch["tokens"], modality=mod,
                              impl=impl)
        loss = cross_entropy(logits, batch["labels"])
    coef = (cfg.moe.router_aux_coef if (cfg.moe and aux_coef is None)
            else (aux_coef or 0.0))
    return loss + coef * aux


# --------------------------------------------------------------- decode ---

def decode_cache_shape(cfg, batch: int, seq: int):
    """{"caches": {block: {sublayer: {leaf: (shape, dtype)}}}, "pos": ((),
    int32)}: caches stacked over groups, raw KV heads; with a ``pre``
    layer also {"pre": {leaf: (shape, dtype)}}, not stacked."""
    pattern, G, pre = B.group_pattern(cfg)
    kve = max(cfg.num_kv_heads, 1)
    per_group = B.group_cache_shape(cfg, pattern, batch, seq, kve)

    def stack(leaf):
        return ((G,) + tuple(leaf[0]), leaf[1])
    caches = {b: {s: {k: stack(v) for k, v in c.items()}
                  for s, c in bv.items()} for b, bv in per_group.items()}
    out = {"caches": caches, "pos": ((), torch.int32)}
    if pre:
        out["pre"] = B.sublayer_cache_shape(cfg, "attn", batch, seq, kve)
    return out


def zero_state(shapes, dev) -> dict:
    """Zeros of a ``decode_cache_shape`` tree on ``dev``."""
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        shp, dt = tree
        return torch.zeros(shp, dtype=dt, device=dev)
    return zeros(shapes)


def _precompute_cross(cfg, params, mem, caches):
    """Fill the cross-attention caches from the memory ``mem`` (B, M, D):
    each cross sublayer's K and V of ``rmsnorm(mem, its norm)`` (JAX's
    decode normalizes the memory where its prefill does not), in
    ``ACT_DTYPE``, stacked over groups.  The cross entries of ``caches``
    are replaced, as JAX's merge replaces them."""
    G = num_groups(params)
    views = group_views(params["groups"], G)
    for bname, sname, kind in B._sublayers(views[0]):
        if kind != "cross":
            continue
        ks, vs = [], []
        for gp in views:
            p = gp[bname][sname]
            h = rmsnorm(mem, p["norm"], cfg.norm_eps)
            ks.append(torch.einsum("btd,dhk->bthk", h, p["wk"].to(mem.dtype)))
            vs.append(torch.einsum("btd,dhk->bthk", h, p["wv"].to(mem.dtype)))
        caches[bname][sname] = {"k": torch.stack(ks).to(ACT_DTYPE),
                                "v": torch.stack(vs).to(ACT_DTYPE)}
    return caches


@torch.inference_mode()
def init_decode_state(cfg, params, batch: int, seq: int, *, modality=None):
    """Decode state on the parameters' device: zeros, and with a VLM's
    ``modality`` the cross caches filled from it."""
    state = zero_state(decode_cache_shape(cfg, batch, seq),
                       params["embed"].device)
    if cfg.modality_dim and modality is not None:
        _precompute_cross(cfg, params, project_modality(params, modality),
                          state["caches"])
    return state


@torch.inference_mode()
def decode_step(cfg, params, state, tokens):
    """tokens: (B, 1) int -> (logits (B, 1, V), state with pos + 1).  The
    state's caches are updated in place.  Attention against the cache is
    the plain chunked path (MLA's absorbed form) and MoE the reference
    loop, so no kernel of the port runs in a decode step, but under a
    sharding policy, whose MoE decode dispatch bins on the rank and
    scatter kernels (``moe._moe_replicated``)."""
    pos = state["pos"]
    x = _embed(params, tokens)
    new_state = {}
    if "pre" in params:
        p = params["pre"]
        x, new_state["pre"] = B.apply_sublayer_decode(
            cfg, p["s0_attn"], "attn", x, state["pre"], pos)
        x, _ = B.apply_sublayer_decode(cfg, p["s1_mlp"], "mlp", x, None, pos)
    for g in range(num_groups(params)):
        x = B.apply_group_decode(cfg, tree_index(params["groups"], g), x,
                                 tree_index(state["caches"], g), pos)
    new_state.update(caches=state["caches"], pos=pos + 1)
    return _head(cfg, params, x), new_state
