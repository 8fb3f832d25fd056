"""DeepSeek-V2's MLA in the port against the JAX package, on the CPU.

* ``ref.flash_attention`` (the plain version of the flash kernel, whose
  MLA entry takes a v narrower than q and k) against JAX's
  ``ref.flash_attention`` on the same numpy inputs with q.k 192 / v 128
  and other unequal widths, ragged S and T, GQA: 2e-5 in f32, 2e-2 in
  bf16 (the tolerances of tests/test_kernels.py:62);
* ``grouped_attend`` with MLA's widths, through the flash dispatch
  (prefill) and the chunked path (decode), against JAX's, in f32 within
  2e-5 and in bf16 within 2e-2;
* ``apply_mla`` (prefill) and the absorbed ``apply_mla_decode``, on JAX's
  parameter tree drawn with numpy at ``reduce_config``'s widths, against
  JAX's, with both packages' ``ACT_DTYPE`` f32: 2e-4 and 5e-3, the
  forward and decode tolerances of tests/test_torch_models.py:6-19 (the
  latent and rope caches are bf16 in both packages);
* the cache shapes are JAX's; the port's absorbed decode departs from
  its own prefill as JAX's does from JAX's (the bf16 caches' rounding),
  within the decode tolerance;
* the wrapper's width rules: (192, 128) and narrower pairs in bf16, one
  width in f32, and which entry's count a width takes.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.lm as jlm
from repro.configs import get_config as jget, reduce_config as jred
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import flash_attention as fa, ops, ref
from repro_torch.models import attention as attn, lm

TOL = {"f32": 2e-5, "bf16": 2e-2}
FWD_TOL, DECODE_TOL = 2e-4, 5e-3
ARCH = "deepseek-v2-236b"


def _arrays(seed, shapes, bf16):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if bf16:       # round once so both packages get the same bf16 values
        out = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
               for a in out]
    return out


def _both(arrs, bf16):
    j = [jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32) for a in arrs]
    t = [torch.from_numpy(a).to(torch.bfloat16 if bf16 else torch.float32)
         for a in arrs]
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# (s, t, h, kh, d, dv, causal): MLA's widths at ragged S, T and GQA, then
# the narrower pairs the (128, 128) and (64, 64) bodies take
WIDTHS = [(1, 1, 4, 4, 192, 128, True), (127, 127, 4, 4, 192, 128, True),
          (129, 129, 8, 2, 192, 128, True), (70, 150, 4, 4, 192, 128, False),
          (100, 100, 4, 4, 136, 72, True), (65, 65, 4, 2, 128, 64, True),
          (33, 33, 2, 2, 64, 32, True)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("s,t,h,kh,d,dv,causal", WIDTHS)
def test_plain_flash_takes_a_narrower_v_as_jax_ref(s, t, h, kh, d, dv,
                                                   causal, bf16):
    arrs = _arrays(s + d + dv, [(1, s, h, d), (1, t, kh, d), (1, t, kh, dv)],
                   bf16)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, bf16)
    got = ref.flash_attention(tq, tk, tv, causal=causal)
    want = jref.flash_attention(jq, jk, jv, causal=causal)
    assert got.shape == (1, s, h, dv) and got.dtype == tq.dtype
    tol = TOL["bf16" if bf16 else "f32"]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_grouped_attend_with_mla_widths_matches_jax(bf16, monkeypatch):
    """MHA groups of one, q.k 24 / v 16 (reduce_config's MLA): prefill
    through the flash dispatch, one decode query through the chunked
    path."""
    B, S, K, qk, dv = 2, 40, 4, 24, 16
    arrs = _arrays(11, [(B, S, K, 1, qk), (B, S, K, qk), (B, S, K, dv)],
                   bf16)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, bf16)
    calls = []
    real = ops.flash_attention

    def spy(*a, **kw):
        calls.append((a[0].shape, a[2].shape))
        return real(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", spy)
    tol = TOL["bf16" if bf16 else "f32"]
    got = attn.grouped_attend(tq, tk, tv, causal=True)
    assert calls == [((B, S, K, qk), (B, S, K, dv))]
    assert got.shape == (B, S, K, 1, dv)
    np.testing.assert_allclose(
        _f32(got), _f32(jattn.grouped_attend(jq, jk, jv, causal=True)),
        atol=tol, rtol=tol)
    pos = 17
    got = attn.grouped_attend(tq[:, :1], tk, tv, causal=False,
                              q_pos=torch.tensor([pos]),
                              kv_len=torch.tensor(pos + 1), chunk=1)
    want = jattn.grouped_attend(jq[:, :1], jk, jv, causal=False,
                                q_pos=jnp.array([pos]),
                                kv_len=jnp.int32(pos + 1), chunk=1)
    assert len(calls) == 1
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.fixture
def mla(monkeypatch):
    """reduce_config's deepseek, one MLA sublayer's parameters (JAX's
    tree, numpy draws), both packages' activations in f32."""
    monkeypatch.setattr(jlm, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(lm, "ACT_DTYPE", torch.float32)
    jcfg, cfg = jred(jget(ARCH)), reduce_config(get_config(ARCH))
    shapes = attn.build_mla(cfg, lambda shape, axes, scale="fan_in":
                            (shape, scale))
    rng = np.random.default_rng(12)
    p = {k: (np.zeros(shp, np.float32) if scale == "zeros" else
             (rng.standard_normal(shp) / np.sqrt(shp[-2] if len(shp) > 1
                                                 else shp[0]))
             .astype(np.float32))
         for k, (shp, scale) in shapes.items()}
    p["q_norm"] += 0.1 * rng.standard_normal(p["q_norm"].shape).astype(
        np.float32)
    return jcfg, cfg, p


def test_mla_params_and_cache_shapes_are_jax(mla):
    jcfg, cfg, p = mla
    jshapes = jattn.build_mla(jcfg, lambda shape, axes, scale="fan_in":
                              tuple(shape))
    assert {k: v.shape for k, v in p.items()} == jshapes
    want = jattn.mla_cache_shape(jcfg, 3, 40)
    got = attn.mla_cache_shape(cfg, 3, 40)
    assert {k: (tuple(s.shape), str(s.dtype)) for k, s in want.items()} == \
        {k: (shp, str(dt).replace("torch.", "")) for k, (shp, dt) in
         got.items()}
    cache = attn.init_mla_cache(cfg, 3, 40)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: shp for k, (shp, _) in got.items()}


def test_apply_mla_matches_jax(mla):
    jcfg, cfg, p = mla
    x = np.random.default_rng(13).standard_normal(
        (2, 48, cfg.d_model)).astype(np.float32)
    want = jax.jit(partial(jattn.apply_mla, jcfg))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = attn.apply_mla(cfg, {k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=FWD_TOL)


def test_absorbed_decode_matches_jax_and_departs_from_prefill_as_jax(mla):
    """Step by step from an empty bf16 cache: each position's output
    against JAX's absorbed decode, and the caches equal to JAX's.  Then
    the decode outputs against the full-sequence MLA (decompressed K and
    V, the flash dispatch): the port's gap equals JAX's own (both are the
    bf16 caches' rounding, up to 0.09 here)."""
    jcfg, cfg, p = mla
    B, S = 2, 12
    x = np.random.default_rng(14).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jc = jattn.init_mla_cache(jcfg, B, S)
    tc = attn.init_mla_cache(cfg, B, S)
    step = jax.jit(partial(jattn.apply_mla_decode, jcfg))
    outs, jouts = [], []
    for t in range(S):
        jy, jc = step(jp, jnp.asarray(x[:, t:t + 1]), jc, jnp.int32(t))
        ty, tc = attn.apply_mla_decode(cfg, tp, torch.from_numpy(
            x[:, t:t + 1]), tc, torch.tensor(t, dtype=torch.int32))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                   atol=DECODE_TOL, rtol=DECODE_TOL)
        outs.append(ty.numpy())
        jouts.append(np.asarray(jy))
    for k in ("latent", "k_rope"):
        np.testing.assert_array_equal(_f32(tc[k]), _f32(jc[k]))
    gap = np.concatenate(outs, 1) - attn.apply_mla(
        cfg, tp, torch.from_numpy(x)).numpy()
    jgap = np.concatenate(jouts, 1) - np.asarray(
        jax.jit(partial(jattn.apply_mla, jcfg))(jp, jnp.asarray(x)))
    np.testing.assert_allclose(gap, jgap, atol=DECODE_TOL, rtol=DECODE_TOL)


def test_flash_wrapper_width_rules():
    bf, f32 = torch.bfloat16, torch.float32
    assert fa.takes_widths(192, 128, bf) and fa.takes_widths(136, 72, bf)
    assert fa.takes_widths(128, 64, bf) and fa.takes_widths(64, 64, f32)
    assert not fa.takes_widths(192, 136, bf)      # v above 128
    assert not fa.takes_widths(200, 128, bf)      # q.k above 192
    assert not fa.takes_widths(192, 128, f32)     # f32: one width
    assert not fa.takes_widths(128, 64, f32)
    assert not fa.takes_widths(196, 128, bf)      # not a multiple of 8
    assert fa.entry(192) == "mla" and fa.entry(136) == "mla"
    assert fa.entry(128) == "flash" and fa.entry(64) == "flash"
    q = torch.zeros((1, 8, 4, 192), dtype=bf)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q[..., :128])
    with pytest.raises(ValueError, match="kernel"):
        ops.flash_attention(q, q, q[..., :128], impl="kernel")
    before = ops.launch_counts()
    out = ops.flash_attention(q, q, q[..., :128])       # plain on the CPU
    assert out.shape == (1, 8, 4, 128)
    assert ops.launch_counts() == before
    assert "flash_attention_mla" in before


@pytest.mark.gpu
def test_mla_entry_matches_plain_on_card():
    """Runs on the card only (``python3 chip_smoke.py`` sweeps far more)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((1, 300, 8, 192), generator=g, device=dev).bfloat16()
    k = torch.randn((1, 300, 8, 192), generator=g, device=dev).bfloat16()
    v = torch.randn((1, 300, 8, 128), generator=g, device=dev).bfloat16()
    before = fa.launches["mla"]
    torch.testing.assert_close(
        ops.flash_attention(q, k, v).float(),
        ops.flash_attention(q, k, v, impl="plain").float(),
        atol=2e-2, rtol=2e-2)
    assert fa.launches["mla"] == before + 1
