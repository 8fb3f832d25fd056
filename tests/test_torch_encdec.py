"""The port's encoder-decoder (whisper-base's family, ``models/encdec.py``)
against the JAX package, on the CPU, at ``reduce_config`` (2 encoder and 2
decoder layers, 16 audio frames of 32 features, GELU MLP, tied head).

Parameters come from ``japi.init_params(PRNGKey(0))`` through
``params_from_numpy``; tokens and features are drawn once with numpy from
a seed.  Tolerances as tests/test_torch_vlm.py's, with both packages'
``ACT_DTYPE`` set to f32: 2e-4 for ``encode``, the forward and the loss,
5e-3 for decode; in bf16 the port's logits lie within twice JAX's own
bf16 error.  Each gradient leaf within rms(diff) <= 1e-3 rms(JAX): on
these weights the reference's init (``fan_in`` = the head count for
``wq``, ``wk``) makes attention nearly one-hot, and each package's f32
gradients lie 2e-4 to 2e-3 from an f64 run of the port (the port's the
nearer), 2e-4 to 5e-4 from each other.

* ``param_shapes``, ``encode`` (non-causal self-attention with rope,
  trap 3; the features cast to bf16 before the projection, trap 4, which
  the bf16 test reaches), ``forward``, ``loss_fn`` and its gradients, the
  cross caches of ``init_decode_state(modality=)`` and three decode steps
  equal JAX's;
* trap 1: the decoder's prefill takes the cross K and V of the encoder's
  output as it is, its decode those of the output normed again; the
  port's prefill-decode gap equals JAX's;
* the plain flash version, non-causal at S 128 and T 256, equals the
  Pallas kernel in interpret mode (2e-5 in f32);
* ``bench.serve.layer_check`` reads the encoder's non-causal layers, the
  decoder's causal self-attention and its cross-attention, in call
  order, and a faulty plain path reads above ROW_TOL on each.
"""
import importlib.util
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.lm as jlm
from repro.configs import get_config as jget, reduce_config as jred
from repro.kernels import ops as jops
from repro.models import api as japi, encdec as jencdec
from repro.train import train_step as jts
from repro_torch.bench import serve as bench_serve
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import ref
from repro_torch.models import api, encdec, lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import train_step as ts
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]
ARCH = "whisper-base"
FWD_TOL, DECODE_TOL, GRAD_RMS = 2e-4, 5e-3, 1e-3


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = jred(jget(ARCH)), reduce_config(get_config(ARCH))
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    mod = rng.standard_normal(
        (2, cfg.num_modality_tokens, cfg.modality_dim)).astype(np.float32)
    return jcfg, cfg, jp, tp, toks, mod


def _set_act(monkeypatch, name):
    """Both packages' activation dtype; JAX's ``encdec`` holds its own
    copy of ``lm.ACT_DTYPE`` (imported by name), the port's reads
    ``lm``'s."""
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[name]
    monkeypatch.setattr(jlm, "ACT_DTYPE", jdt)
    monkeypatch.setattr(jencdec, "ACT_DTYPE", jdt)
    monkeypatch.setattr(lm, "ACT_DTYPE", {"f32": torch.float32,
                                          "bf16": torch.bfloat16}[name])


@pytest.fixture
def f32(monkeypatch):
    _set_act(monkeypatch, "f32")


def _j(x):
    return np.asarray(x, np.float32)


def _rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(((a - b) ** 2).mean()) / max(np.sqrt((b ** 2).mean()),
                                                1e-30)


def _forward(pair):
    jcfg, cfg, jp, tp, toks, mod = pair
    jl, _ = jax.jit(lambda p, t, m: japi.forward(jcfg, p, t, modality=m,
                                                 remat=False))(
        jp, jnp.asarray(toks), jnp.asarray(mod))
    tl, aux = api.forward(cfg, tp, torch.from_numpy(toks).long(),
                          modality=torch.from_numpy(mod))
    assert float(aux) == 0.0 and tl.shape == (*toks.shape, cfg.vocab_size)
    return _j(jl), tl.float().numpy()


def test_init_params_has_jax_tree_and_shapes(pair):
    jcfg, cfg, jp, _, _, _ = pair
    want = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert api.param_shapes(cfg) == want
    assert {"mod_proj", "enc_pos", "enc_groups", "enc_norm"} <= set(want)
    assert "lm_head" not in want                          # tied
    tp = api.init_params(cfg, torch.Generator().manual_seed(0),
                         dtype=torch.bfloat16, device="cpu")
    assert lm.tree_map(lambda t: tuple(t.shape), tp) == want


def test_encode_matches_jax_f32(pair, f32):
    jcfg, cfg, jp, tp, _, mod = pair
    want = jax.jit(lambda p, m: jencdec.encode(jcfg, p, m))(
        jp, jnp.asarray(mod))
    got = encdec.encode(cfg, tp, torch.from_numpy(mod))
    assert got.shape == (*mod.shape[:2], cfg.d_model)
    np.testing.assert_allclose(got.numpy(), _j(want), atol=FWD_TOL,
                               rtol=FWD_TOL)


def test_forward_matches_jax_f32(pair, f32):
    jl, tl = _forward(pair)
    np.testing.assert_allclose(tl, jl, atol=FWD_TOL, rtol=FWD_TOL)


def test_forward_bf16_within_jax_own_bf16_rounding(pair, monkeypatch):
    _set_act(monkeypatch, "f32")
    ref32, _ = _forward(pair)
    _set_act(monkeypatch, "bf16")
    jl, tl = _forward(pair)
    assert np.isfinite(tl).all()
    assert np.abs(tl - jl).max() <= 2 * np.abs(jl - ref32).max()


def test_loss_and_grads_match_jax(pair, f32):
    jcfg, cfg, jp, tp, toks, mod = pair
    b = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
         "modality": mod}
    jl, jg = jax.jit(lambda p, bb: jts._loss_and_grads(jcfg, p, bb, 1))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tl, tg = ts._loss_and_grads(cfg, tp, {k: torch.from_numpy(v)
                                          for k, v in b.items()}, 1)
    np.testing.assert_allclose(float(tl), float(jl), rtol=FWD_TOL)
    flat_t, flat_j = leaves(tg), jax.tree.leaves(jg)
    assert len(flat_t) == len(flat_j)
    for a, j in zip(flat_t, flat_j):
        assert a.shape == j.shape
        assert _rel_rms(a.numpy(), j) <= GRAD_RMS
    assert float(np.abs(tg["enc_pos"].numpy()).max()) > 0


def _decode_both(pair, steps, B=2, seq=8):
    jcfg, cfg, jp, tp, toks, mod = pair
    js = japi.init_decode_state(jcfg, jp, B, seq,
                                modality=jnp.asarray(mod[:B]))
    ts_ = api.init_decode_state(cfg, tp, B, seq,
                                modality=torch.from_numpy(mod[:B]))
    step = jax.jit(partial(japi.decode_step, jcfg))
    out = []
    for t in range(steps):
        a, js = step(jp, js, jnp.asarray(toks[:B, t:t + 1]))
        b, ts_ = api.decode_step(cfg, tp, ts_,
                                 torch.from_numpy(toks[:B, t:t + 1]).long())
        assert int(ts_["pos"]) == t + 1
        out.append((_j(a), b.float().numpy()))
    return out


def test_cross_caches_and_decode_match_jax(pair, f32):
    """The state's tree, shapes and dtypes (the cross caches in
    ACT_DTYPE, the self-attention caches bf16), the cross K and V of
    every decoder layer, and three decode steps' logits equal JAX's."""
    jcfg, cfg, jp, tp, toks, mod = pair
    js = japi.init_decode_state(jcfg, jp, 2, 8, modality=jnp.asarray(mod))
    ts_ = api.init_decode_state(cfg, tp, 2, 8,
                                modality=torch.from_numpy(mod))
    assert lm.tree_map(lambda t: (tuple(t.shape),
                                  str(t.dtype).split(".")[-1]),
                       ts_) == jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)), js)
    blk = "b0_attn_cross_mlp"
    for kv in ("k", "v"):
        got = ts_["caches"][blk]["s1_cross"][kv].numpy()
        want = _j(js["caches"][blk]["s1_cross"][kv])
        assert want.shape[:3] == (cfg.num_layers, 2, cfg.num_modality_tokens)
        np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL)
    for jl, tl in _decode_both(pair, 3):
        np.testing.assert_allclose(tl, jl, atol=DECODE_TOL, rtol=DECODE_TOL)


def test_prefill_decode_gap_equals_jax(pair, f32):
    """Trap 1, in the decoder's cross layers: teacher-forced decode
    departs from the prefill logits by JAX's own gap.  The encoder's
    output is normed already, so with the init's zero norm weights a
    second norm changes little; the cross norms are drawn here (the same
    numbers for both packages), which makes the gap plain."""
    jcfg, cfg, jp, tp, toks, mod = pair
    tree = jax.tree.map(np.array, jp)
    cross = tree["groups"]["b0_attn_cross_mlp"]["s1_cross"]
    cross["norm"] = np.random.default_rng(2).standard_normal(
        cross["norm"].shape).astype(np.float32) * 0.5
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(cfg, tree, device="cpu")
    B, S = 1, 8
    sub = (jcfg, cfg, jp, tp, toks[:B, :S], mod[:B])
    full, _ = api.forward(cfg, tp, torch.from_numpy(sub[4]).long(),
                          modality=torch.from_numpy(sub[5]))
    jfull, _ = japi.forward(jcfg, jp, jnp.asarray(sub[4]),
                            modality=jnp.asarray(sub[5]), remat=False)
    steps = _decode_both(sub, S, B=B, seq=S)
    gap = np.concatenate([t for _, t in steps], 1) - full.numpy()
    jgap = np.concatenate([j for j, _ in steps], 1) - _j(jfull)
    assert np.abs(jgap).max() > 10 * DECODE_TOL
    np.testing.assert_allclose(gap, jgap, atol=DECODE_TOL, rtol=DECODE_TOL)


def test_plain_noncausal_flash_matches_pallas_interpret():
    """``ref.flash_attention(causal=False)`` at S 128, T 256 (GQA 8 over
    2) against the Pallas ``flash_attention`` in interpret mode."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 128, 8, 64), (2, 256, 2, 64), (2, 256, 2, 64)))
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=False, block_q=64,
                                block_k=64)
    got = ref.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=False)
    np.testing.assert_allclose(got.numpy(), _j(want), atol=2e-5, rtol=2e-5)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_layer_check_reads_encoder_and_decoder_layers():
    """Call order: the encoder's two non-causal layers (S = T = 160
    frames), then each decoder layer's causal self-attention (S = 256)
    and cross-attention (T = 160); all 0 on the CPU, and each above
    ROW_TOL with chip_smoke's dropped-tile plain attention.  ``groups=1``
    cuts the encoder and the decoder to one layer each."""
    smoke = _chip_smoke()
    cfg = reduce_config(get_config(ARCH))
    cfg = type(cfg)(**{**cfg.__dict__, "num_modality_tokens": 160})
    params = bench_serve.weights(cfg, device="cpu")
    tokens = bench_serve.prompt(cfg, 1, 256, torch.device("cpu"))
    mod = bench_serve.modality(cfg, 1, torch.device("cpu"))
    got = bench_serve.layer_check(cfg, params, tokens, modality=mod)
    assert got["kinds"] == ["flash_noncausal"] * 2 + [
        "flash_attention", "flash_noncausal"] * 2
    assert got["per_layer"] == [0.0] * 6
    with smoke.faulty_plain("flash_attention"):
        bad = bench_serve.layer_check(cfg, params, tokens, modality=mod,
                                      groups=1)
    assert bad["kinds"] == ["flash_noncausal", "flash_attention",
                            "flash_noncausal"]
    assert min(bad["per_layer"]) > smoke.ROW_TOL
