"""Grouped-query attention, full sequence and decode (the GQA half of
``repro.models.attention``).

Full-sequence causal attention (every prefill and every training
forward) runs the hand-written flash kernel through
:func:`repro_torch.kernels.ops.flash_attention`: the JAX model names that
swap in its docstring but runs a chunked stand-in, and trains through it.
So the kernel's gradient is the chunked path's (:func:`chunked_attend`),
recomputed in the backward.  Every other case (decode against a cache
with ``kv_len``, explicit positions, T != S) keeps the chunked plain
path.  MLA and
cross-attention are not ported yet (ROADMAP queue 1 item 6).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, rope_angles

NEG_INF = -1e30


def kv_heads_eff(cfg) -> int:
    """KV heads after replication for tensor parallelism.  The port runs
    on one card (tp = 1), where no head is replicated."""
    return cfg.num_kv_heads


def build_gqa(cfg, mk):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    return {"wq": mk((d, h, hd)), "wk": mk((d, kv, hd)),
            "wv": mk((d, kv, hd)), "wo": mk((h, hd, d))}


def grouped_attend(q, k, v, *, causal: bool, q_pos=None, kv_len=None,
                   chunk: int = 512, impl=None):
    """Grouped-query attention.

    q: (B, S, K, G, hd) -- K kv-head groups x G queries per group;
    k, v: (B, T, K, hd); q_pos: int (S,) absolute query positions (None =
    0..S-1); kv_len: valid KV prefix length (decode), None = all valid.
    Returns (B, S, K, G, hd_v).

    The causal full-sequence case (no kv_len, default positions, T == S)
    goes to the flash kernel, with heads flattened so that head k*G + g
    reads kv head k; the kernel's wrapper raises on a shape it does not
    take.  Its gradient is that of :func:`chunked_attend`, the function
    the JAX package trains through.  Every other case runs
    :func:`chunked_attend`."""
    B, S, K, G, hd = q.shape
    T = k.shape[1]
    if causal and kv_len is None and q_pos is None and T == S:
        out = ops.flash_attention(q.reshape(B, S, K * G, hd), k, v,
                                  causal=True, impl=impl,
                                  backward=_flat_chunked_attend)
        return out.reshape(B, S, K, G, hd)
    return chunked_attend(q, k, v, causal=causal, q_pos=q_pos,
                          kv_len=kv_len, chunk=chunk)


def _flat_chunked_attend(q, k, v, causal):
    """:func:`chunked_attend` on the kernel's layout: q (B, S, H, hd)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    out = chunked_attend(q.reshape(B, S, K, H // K, hd), k, v,
                         causal=causal)
    return out.reshape(B, S, H, hd)


def chunked_attend(q, k, v, *, causal: bool, q_pos=None, kv_len=None,
                   chunk: int = 512):
    """The JAX package's chunked attention: scores are taken in f32 over
    query chunks, masked at -1e30, softmaxed, and p is cast to v's dtype
    before P.V.  Shapes as :func:`grouped_attend`'s."""
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
        s = torch.einsum("bckgd,btkd->bkgct", qc.to(torch.float32),
                         kf) * scale
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


def apply_gqa(cfg, p, x, *, impl=None):
    """Full-sequence causal self-attention at positions 0..S-1.  x: (B, S,
    D).  The JAX function's ``positions``, ``causal=False`` and ``kv_x``
    serve the encoder-decoder and cross-attention, not ported yet."""
    B, S, D = x.shape
    h, hd = cfg.num_heads, cfg.hd
    kve = kv_heads_eff(cfg)
    G = h // kve
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("btd,dhk->bthk", x, p["wk"].to(x.dtype))
    v = torch.einsum("btd,dhk->bthk", x, p["wv"].to(x.dtype))
    if cfg.rope_theta > 0:
        pos = torch.arange(S, dtype=torch.int32, device=x.device)
        cos, sin = rope_angles(pos, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    ctx = grouped_attend(q.reshape(B, S, kve, G, hd), k, v, causal=True,
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


def apply_gqa_decode(cfg, p, x, cache, pos):
    """One-token decode.  x: (B, 1, D); cache k/v: (B, T, KVe, hd); pos: a
    0-d int tensor.  The new key and value are written into the cache in
    place at ``min(pos, T - 1)`` (where JAX's ``dynamic_update_slice``
    clamps the start), and the cache is returned."""
    B = x.shape[0]
    h, hd = cfg.num_heads, cfg.hd
    T, kve = cache["k"].shape[1], cache["k"].shape[2]
    G = h // kve
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    knew = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    vnew = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if cfg.rope_theta > 0:
        cos, sin = rope_angles(pos.reshape(1), hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        knew = apply_rope(knew, cos, sin)
    at = pos.reshape(1).clamp(max=T - 1).to(torch.int64)
    cache["k"].index_copy_(1, at, knew.to(cache["k"].dtype))
    cache["v"].index_copy_(1, at, vnew.to(cache["v"].dtype))
    ctx = grouped_attend(q.reshape(B, 1, kve, G, hd),
                         cache["k"].to(x.dtype), cache["v"].to(x.dtype),
                         causal=False, q_pos=pos.reshape(1), kv_len=pos + 1,
                         chunk=1)
    y = torch.einsum("bshk,hkd->bsd", ctx.reshape(B, 1, h, hd),
                     p["wo"].to(x.dtype))
    return y, cache
