"""Layer-group machinery (a port of ``repro.models.blocks``).

Every architecture is normalized to a *group pattern*: a short list of
blocks (each a tuple of sublayers) that repeats G times.  Parameters are
stacked over G as in the JAX package; the port runs the groups in a Python
loop instead of a ``lax.scan``.  The JAX ``RS_OUTPUTS`` sharding toggle has
no meaning on one card and is not copied.

The port runs every sublayer kind: ``attn`` (GQA, or MLA where the
config has one), ``cross`` (GQA whose K and V come from the modality
memory ``mem``), ``ssm``, ``mlp`` and ``moe``: every family.  A
full-sequence sublayer returns (x, aux), aux the MoE router's
load-balancing loss (0.0 for the other kinds), as JAX's does.
"""
from __future__ import annotations

from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.common import apply_mlp, build_mlp, rmsnorm

def group_pattern(cfg):
    """Returns (pattern, G, has_pre_layer). pattern: list of block tuples.
    ``encdec`` gives the decoder's pattern (``encdec`` builds the
    encoder's)."""
    fam = cfg.family
    if fam in ("dense", "vlm") or (fam == "moe" and cfg.moe is None):
        pat = [("attn", "mlp")]
        if fam == "vlm" and cfg.cross_attn_every:
            per = cfg.cross_attn_every
            pat = [("attn", "mlp")] * (per - 1) + [("cross", "mlp")]
        G, r = divmod(cfg.num_layers, len(pat))
        assert r == 0, (cfg.name, cfg.num_layers, len(pat))
        return pat, G, False
    if fam == "moe":
        m = cfg.moe
        pre = m.first_dense > 0
        layers = cfg.num_layers - m.first_dense
        pat = []
        for o in range(m.period):
            gi = m.first_dense + o
            pat.append(("attn", "moe" if (gi + 1) % m.period == 0
                        or m.period == 1 else "mlp"))
        if m.period == 1:
            pat = [("attn", "moe")]
        G, r = divmod(layers, len(pat))
        assert r == 0, (cfg.name, layers, len(pat))
        return pat, G, pre
    if fam == "ssm":
        return [("ssm",)], cfg.num_layers, False
    if fam == "hybrid":
        per = cfg.attn_every
        m = cfg.moe
        pat = []
        for o in range(per):
            mixer = "attn" if o == per - 1 else "ssm"
            ffn = "mlp"
            if m is not None and (o + 1) % m.period == 0:
                ffn = "moe"
            pat.append((mixer, ffn))
        G, r = divmod(cfg.num_layers, per)
        assert r == 0, (cfg.name, cfg.num_layers, per)
        return pat, G, False
    if fam == "encdec":
        return [("attn", "cross", "mlp")], cfg.num_layers, False
    raise ValueError(fam)


def build_sublayer(cfg, mk, kind: str):
    p = {"norm": mk((cfg.d_model,), (None,), "zeros")}
    if kind == "attn":
        p.update(A.build_mla(cfg, mk) if cfg.mla else A.build_gqa(cfg, mk))
    elif kind == "cross":
        p.update(A.build_gqa(cfg, mk))
    elif kind == "ssm":
        p.update(S.build_ssm(cfg, mk))
    elif kind == "mlp":
        p.update(build_mlp(cfg, mk))
    elif kind == "moe":
        p.update(M.build_moe(cfg, cfg.moe, mk))
    else:
        raise ValueError(kind)
    return p


def build_group(cfg, mk, pattern):
    return {f"b{i}_{'_'.join(blk)}":
            {f"s{j}_{kind}": build_sublayer(cfg, mk, kind)
             for j, kind in enumerate(blk)}
            for i, blk in enumerate(pattern)}


def _sublayers(gp):
    """(block name, sublayer name, kind) in the JAX package's order."""
    for bname in sorted(gp):
        for sname in sorted(gp[bname]):
            yield bname, sname, sname.split("_", 1)[1]


def apply_sublayer(cfg, p, kind, x, *, mem=None, causal=True, impl=None):
    """Full-sequence sublayer with pre-norm and residual: (x, aux).
    ``causal`` is self-attention's (False in whisper's encoder); ``cross``
    takes K and V from ``mem`` as it is (the norm is x's alone), or, with
    ``mem`` None, attends over x itself, non-causal with rope, as JAX's
    does."""
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    aux = 0.0
    if kind == "attn":
        y = (A.apply_mla(cfg, p, h, impl=impl) if cfg.mla
             else A.apply_gqa(cfg, p, h, causal=causal, impl=impl))
    elif kind == "cross":
        y = A.apply_gqa(cfg, p, h, kv_x=mem, causal=False, impl=impl)
    elif kind == "ssm":
        y = S.apply_ssm(cfg, p, h, impl=impl)
    elif kind == "mlp":
        y = apply_mlp(cfg, p, h)
    elif kind == "moe":
        y, aux = M.apply_moe(cfg, cfg.moe, p, h, impl=impl)
    else:
        raise ValueError(kind)
    return x + y, aux


def apply_group(cfg, gp, x, *, mem=None, causal=True, impl=None):
    """The group's sublayers in JAX's order: (x, summed aux)."""
    aux = 0.0
    for bname, sname, kind in _sublayers(gp):
        x, a = apply_sublayer(cfg, gp[bname][sname], kind, x, mem=mem,
                              causal=causal, impl=impl)
        aux = aux + a
    return x, aux


# ------------------------------------------------------------- decode -----

def sublayer_cache_shape(cfg, kind: str, batch: int, seq: int, kve: int):
    """{leaf: (shape, dtype)} of one sublayer's decode state, or None."""
    if kind == "attn":
        if cfg.mla:
            return A.mla_cache_shape(cfg, batch, seq)
        return A.gqa_cache_shape(cfg, batch, seq, kve)
    if kind == "cross":
        m = max(cfg.num_modality_tokens, 1)
        return A.gqa_cache_shape(cfg, batch, m, kve)
    if kind == "ssm":
        return S.ssm_state_shape(cfg, batch)
    return None


def group_cache_shape(cfg, pattern, batch: int, seq: int, kve: int):
    out = {}
    for i, blk in enumerate(pattern):
        b = {}
        for j, kind in enumerate(blk):
            cs = sublayer_cache_shape(cfg, kind, batch, seq, kve)
            if cs is not None:
                b[f"s{j}_{kind}"] = cs
        if b:
            out[f"b{i}_{'_'.join(blk)}"] = b
    return out


def apply_sublayer_decode(cfg, p, kind, x, cache, pos):
    """One-token sublayer; its cache is updated in place (a cross cache is
    only read).  MoE runs the reference loop (JAX's one-device decode)."""
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    if kind == "attn":
        if cfg.mla:
            y, cache = A.apply_mla_decode(cfg, p, h, cache, pos)
        else:
            y, cache = A.apply_gqa_decode(cfg, p, h, cache, pos)
    elif kind == "cross":
        y, cache = A.apply_gqa_decode(cfg, p, h, cache, pos, cross=True)
    elif kind == "ssm":
        y, cache = S.apply_ssm_decode(cfg, p, h, cache)
    elif kind == "mlp":
        y = apply_mlp(cfg, p, h)
    elif kind == "moe":
        y, _ = M.apply_moe(cfg, cfg.moe, p, h, decode=True)
    else:
        raise ValueError(kind)
    return x + y, cache


def apply_group_decode(cfg, gp, x, caches, pos):
    for bname, sname, kind in _sublayers(gp):
        c = caches.get(bname, {}).get(sname)
        x, _ = apply_sublayer_decode(cfg, gp[bname][sname], kind, x, c, pos)
    return x
