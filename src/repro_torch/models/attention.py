"""Attention: GQA, cross-attention and DeepSeek-V2's MLA, full sequence
and decode (a port of ``repro.models.attention``).

Every full-sequence attention (every prefill and every training forward)
runs the hand-written flash kernel through
:func:`repro_torch.kernels.ops.flash_attention`: causal self-attention,
and non-causal attention over any number T of keys (whisper's encoder,
the VLM's and whisper's cross-attention, whose K and V come from the
modality memory).  The JAX model names that swap in its docstring but runs
a chunked stand-in, and trains through it.  So the kernel's gradient is
the chunked path's (:func:`chunked_attend`), recomputed in the backward.
MLA's prefill decompresses K and V per head (q.k width 192, v width 128)
and takes the kernel's MLA entry.  Every other case (decode against a
cache with ``kv_len``, cross-attention decode against the memory's cache,
explicit positions, causal T != S) keeps the chunked plain path; MLA
decode is JAX's absorbed form, attention in the compressed latent space,
in plain torch.  Under a sharding policy whose 'model' axis exceeds a GQA
model's KV heads, K and V heads are replicated as JAX's are
(:func:`kv_heads_eff`); decode caches keep the raw KV heads.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, rmsnorm, rope_angles
from repro_torch.sharding import constrain, current_policy

NEG_INF = -1e30


def tp_size() -> int:
    """The 'model' axis of the calling thread's policy: 1 with no policy
    or no mesh."""
    pol = current_policy()
    if pol is None or pol.mesh is None:
        return 1
    return pol.mesh.shape.get("model", 1)


def kv_heads_eff(cfg) -> int:
    """KV heads after replication for tensor parallelism (Megatron-style
    KV-head replication when num_kv_heads < tp): the largest multiple of
    num_kv_heads that both divides num_heads and is <= tp.  With no
    policy (tp = 1) no head is replicated."""
    tp = tp_size()
    kv, h = cfg.num_kv_heads, cfg.num_heads
    if kv >= tp:
        return kv
    best = kv
    m = kv
    while m <= tp:
        if h % m == 0:
            best = m
        m += kv
    return best


def _repeat_kv_weight(w, kv: int, kv_eff: int):
    """A K or V projection (d, kv, hd) with each head repeated kv_eff / kv
    times in place, as JAX's ``jnp.repeat`` on axis 1: head j of the
    result is head j // (kv_eff / kv) of w."""
    if kv_eff == kv:
        return w
    return torch.repeat_interleave(w, kv_eff // kv, dim=1)


def build_gqa(cfg, mk):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    return {"wq": mk((d, h, hd), ("embed", "heads", None)),
            "wk": mk((d, kv, hd), ("embed", None, None)),
            "wv": mk((d, kv, hd), ("embed", None, None)),
            "wo": mk((h, hd, d), ("heads", None, "embed"))}


def grouped_attend(q, k, v, *, causal: bool, q_pos=None, kv_len=None,
                   chunk: int = 512, impl=None):
    """Grouped-query attention.

    q: (B, S, K, G, hd) -- K kv-head groups x G queries per group;
    k, v: (B, T, K, hd); q_pos: int (S,) absolute query positions (None =
    0..S-1); kv_len: valid KV prefix length (decode), None = all valid.
    v may be narrower than q and k (MLA).  Returns (B, S, K, G, hd_v).

    Every full-sequence call (no kv_len, default positions) goes to the
    flash kernel, non-causal with any T, causal with T == S, with heads
    flattened so that head k*G + g reads kv head k; the kernel's wrapper
    raises on a shape it does not take.  Its gradient is that of
    :func:`chunked_attend`, the function the JAX package trains through.
    Every other case runs :func:`chunked_attend`."""
    B, S, K, G, hd = q.shape
    T = k.shape[1]
    if kv_len is None and q_pos is None and (T == S or not causal):
        out = ops.flash_attention(q.reshape(B, S, K * G, hd), k, v,
                                  causal=causal, impl=impl,
                                  backward=_flat_chunked_attend)
        return out.reshape(B, S, K, G, v.shape[-1])
    return chunked_attend(q, k, v, causal=causal, q_pos=q_pos,
                          kv_len=kv_len, chunk=chunk)


def _flat_chunked_attend(q, k, v, causal):
    """:func:`chunked_attend` on the kernel's layout: q (B, S, H, hd), out
    (B, S, H, hd_v)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    out = chunked_attend(q.reshape(B, S, K, H // K, hd), k, v,
                         causal=causal)
    return out.reshape(B, S, H, v.shape[-1])


def chunked_attend(q, k, v, *, causal: bool, q_pos=None, kv_len=None,
                   chunk: int = 512, scores=None):
    """The JAX package's chunked attention: scores are taken in f32 over
    query chunks, masked at -1e30, softmaxed, and p is cast to v's dtype
    before P.V.  Shapes as :func:`grouped_attend`'s.  ``scores(qc, kf)``,
    if given, takes the unscaled f32 scores (B, K, G, c, T) of a chunk in
    place of the f32 einsum (a check rounds them another way)."""
    B, S, K, G, hd = q.shape
    T = k.shape[1]
    scale = hd ** -0.5
    kv_pos = torch.arange(T, dtype=torch.int32, device=q.device)
    if q_pos is None:
        q_pos = torch.arange(S, dtype=torch.int32, device=q.device)
    # adaptive q-chunk: keep the f32 score block ~<= 1 GB; must divide S
    if S > chunk:
        c = int(1e9) // max(B * K * G * T * 4, 1)
        c = max(128, min(chunk, (c // 128) * 128))
        while c > 1 and S % c:
            c -= 1
        chunk = c if S % c == 0 else S
    kf = k.to(torch.float32)

    def block(qc, qp):
        qf = qc.to(torch.float32)
        s = (torch.einsum("bckgd,btkd->bkgct", qf, kf) if scores is None
             else scores(qf, kf)) * scale
        mask = torch.ones((qc.shape[1], T), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask = kv_pos[None, :] <= qp[:, None]
        if kv_len is not None:
            mask = mask & (kv_pos[None, :] < kv_len)
        s = torch.where(mask[None, None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bkgct,btkd->bckgd", p.to(v.dtype), v)

    if S <= chunk:
        return block(q, q_pos)
    return torch.cat([block(q[:, i:i + chunk], q_pos[i:i + chunk])
                      for i in range(0, S, chunk)], dim=1)


def apply_gqa(cfg, p, x, *, positions=None, causal=True, kv_x=None,
              impl=None):
    """Full-sequence self- or cross-attention.  x: (B, S, D); kv_x: (B, T,
    D), the memory cross-attention takes K and V from (no rope, never
    causal), or None for self-attention over x (rope when
    ``cfg.rope_theta > 0``, causal as asked).  ``positions``: the queries'
    (and self-attention keys') positions, 0..S-1 if None; given, they go
    to the chunked path as JAX's ``q_pos``."""
    B, S, D = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    kve = kv_heads_eff(cfg)
    G = h // kve
    src = x if kv_x is None else kv_x
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    wk = _repeat_kv_weight(p["wk"], kv, kve).to(x.dtype)
    wv = _repeat_kv_weight(p["wv"], kv, kve).to(x.dtype)
    k = torch.einsum("btd,dhk->bthk", src, wk)
    v = torch.einsum("btd,dhk->bthk", src, wv)
    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, "kv_heads", None)
    v = constrain(v, "batch", None, "kv_heads", None)
    if kv_x is None and cfg.rope_theta > 0:
        pos = positions if positions is not None else torch.arange(
            S, dtype=torch.int32, device=x.device)
        cos, sin = rope_angles(pos, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    ctx = grouped_attend(q.reshape(B, S, kve, G, hd), k, v,
                         causal=causal and kv_x is None, q_pos=positions,
                         impl=impl)
    return torch.einsum("bshk,hkd->bsd", ctx.reshape(B, S, h, hd),
                        p["wo"].to(x.dtype))


def gqa_cache_shape(cfg, batch: int, seq: int, kve: int,
                    dtype=torch.bfloat16):
    shp = (batch, seq, kve, cfg.hd)
    return {"k": (shp, dtype), "v": (shp, dtype)}


def init_gqa_cache(cfg, batch: int, seq: int, dtype=torch.bfloat16,
                   device=None):
    kve = max(cfg.num_kv_heads, 1)
    shp = (batch, seq, kve, cfg.hd)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def apply_gqa_decode(cfg, p, x, cache, pos, *, cross: bool = False):
    """One-token decode.  x: (B, 1, D); cache k/v: (B, T, KVe, hd); pos: a
    0-d int tensor.  Self-attention writes the new key and value into the
    cache in place at ``min(pos, T - 1)`` (where JAX's
    ``dynamic_update_slice`` clamps the start) and attends to its first
    pos + 1 entries.  Cross-attention (``cross``): the cache is the
    memory's K and V, filled once (``lm._precompute_cross``); no rope, no
    update, every one of its T rows attended.  The cache is returned."""
    B = x.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    T, kve = cache["k"].shape[1], cache["k"].shape[2]
    G = h // kve
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    kv_len = None
    if not cross:
        wk = _repeat_kv_weight(p["wk"], kv, kve).to(x.dtype)
        wv = _repeat_kv_weight(p["wv"], kv, kve).to(x.dtype)
        knew = torch.einsum("bsd,dhk->bshk", x, wk)
        vnew = torch.einsum("bsd,dhk->bshk", x, wv)
        if cfg.rope_theta > 0:
            cos, sin = rope_angles(pos.reshape(1), hd, cfg.rope_theta)
            q = apply_rope(q, cos, sin)
            knew = apply_rope(knew, cos, sin)
        at = pos.reshape(1).clamp(max=T - 1).to(torch.int64)
        cache["k"].index_copy_(1, at, knew.to(cache["k"].dtype))
        cache["v"].index_copy_(1, at, vnew.to(cache["v"].dtype))
        kv_len = pos + 1
    ctx = grouped_attend(q.reshape(B, 1, kve, G, hd),
                         cache["k"].to(x.dtype), cache["v"].to(x.dtype),
                         causal=False, q_pos=pos.reshape(1), kv_len=kv_len,
                         chunk=1)
    y = torch.einsum("bshk,hkd->bsd", ctx.reshape(B, 1, h, hd),
                     p["wo"].to(x.dtype))
    return y, cache


# ---------------------------------------------------------------- MLA -----

def build_mla(cfg, mk):
    m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {"wq_a": mk((d, m.q_lora_rank), ("embed", None)),
            "q_norm": mk((m.q_lora_rank,), (None,), "zeros"),
            "wq_b": mk((m.q_lora_rank, h, qk), (None, "heads", None)),
            "wkv_a": mk((d, m.kv_lora_rank + m.qk_rope_head_dim),
                        ("embed", None)),
            "kv_norm": mk((m.kv_lora_rank,), (None,), "zeros"),
            "wkv_b": mk((m.kv_lora_rank, h,
                         m.qk_nope_head_dim + m.v_head_dim),
                        (None, "heads", None)),
            "wo": mk((h, m.v_head_dim, d), ("heads", None, "embed"))}


def _mla_qkv(cfg, p, x, positions):
    """(q_nope (B, S, h, nope), q_rope (B, S, h, rope) rotated, latent (B,
    S, kv_lora) normed, k_rope (B, S, rope) rotated, one for all heads)."""
    m = cfg.mla
    ql = rmsnorm(torch.einsum("bsd,dr->bsr", x, p["wq_a"].to(x.dtype)),
                 p["q_norm"], cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", ql, p["wq_b"].to(x.dtype))
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    kv_a = torch.einsum("bsd,dr->bsr", x, p["wkv_a"].to(x.dtype))
    latent = rmsnorm(kv_a[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = kv_a[..., m.kv_lora_rank:][:, :, None, :]
    cos, sin = rope_angles(positions, m.qk_rope_head_dim, cfg.rope_theta)
    return (q_nope, apply_rope(q_rope, cos, sin), latent,
            apply_rope(k_rope, cos, sin)[:, :, 0, :])


def apply_mla(cfg, p, x, *, impl=None):
    """MLA over the full sequence at positions 0..S-1 (train and prefill):
    K and V decompressed from the latent for every head, the shared rope
    key broadcast to all, then causal attention with q.k width nope + rope
    and v width v_head_dim (the flash kernel's MLA entry)."""
    m = cfg.mla
    B, S, _ = x.shape
    h = cfg.num_heads
    pos = torch.arange(S, dtype=torch.int32, device=x.device)
    q_nope, q_rope, latent, k_rope = _mla_qkv(cfg, p, x, pos)
    kv = torch.einsum("bsr,rhk->bshk", latent, p["wkv_b"].to(x.dtype))
    k_nope, v = kv[..., :m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, h, m.qk_rope_head_dim)], dim=-1)
    ctx = grouped_attend(q[:, :, :, None, :], k, v, causal=True, impl=impl)
    return torch.einsum("bshk,hkd->bsd", ctx[:, :, :, 0],
                        p["wo"].to(x.dtype))


def mla_cache_shape(cfg, batch: int, seq: int, dtype=torch.bfloat16):
    m = cfg.mla
    return {"latent": ((batch, seq, m.kv_lora_rank), dtype),
            "k_rope": ((batch, seq, m.qk_rope_head_dim), dtype)}


def init_mla_cache(cfg, batch: int, seq: int, dtype=torch.bfloat16,
                   device=None):
    return {k: torch.zeros(shp, dtype=dt, device=device)
            for k, (shp, dt) in mla_cache_shape(cfg, batch, seq,
                                                dtype).items()}


def apply_mla_decode(cfg, p, x, cache, pos):
    """Absorbed MLA decode: the cache holds the latent and the rope key
    (576 values a token and layer at deepseek's widths), and attention
    runs in the latent space (q_nope absorbed into wkv_b's key half, the
    context expanded by its value half).  The new entries are written in
    place at ``min(pos, T - 1)``, as :func:`apply_gqa_decode` does."""
    m = cfg.mla
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    q_nope, q_rope, latent_new, k_rope_new = _mla_qkv(cfg, p, x,
                                                      pos.reshape(1))
    T = cache["latent"].shape[1]
    at = pos.reshape(1).clamp(max=T - 1).to(torch.int64)
    cache["latent"].index_copy_(1, at, latent_new.to(cache["latent"].dtype))
    cache["k_rope"].index_copy_(1, at, k_rope_new.to(cache["k_rope"].dtype))
    lat = cache["latent"].to(x.dtype)                      # (B, T, r)
    krp = cache["k_rope"].to(x.dtype)                      # (B, T, rope)
    wkv_b = p["wkv_b"].to(x.dtype)
    w_k = wkv_b[..., :m.qk_nope_head_dim]                  # (r, h, nope)
    w_v = wkv_b[..., m.qk_nope_head_dim:]                  # (r, h, v)
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, w_k)
    f32 = torch.float32
    s = (torch.einsum("bshr,btr->bhst", q_abs.to(f32), lat.to(f32))
         + torch.einsum("bshk,btk->bhst", q_rope.to(f32), krp.to(f32))
         ) * scale
    valid = torch.arange(T, device=x.device)[None, None, None, :] <= pos
    s = torch.where(valid, s, NEG_INF)
    prob = torch.softmax(s, dim=-1).to(x.dtype)
    ctx_lat = torch.einsum("bhst,btr->bshr", prob, lat)
    ctx = torch.einsum("bshr,rhk->bshk", ctx_lat, w_v)
    y = torch.einsum("bshk,hkd->bsd", ctx, p["wo"].to(x.dtype))
    return y, cache
