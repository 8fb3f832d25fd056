"""The port's VLM (llama-3.2 vision: cross-attention layers over projected
modality features) against the JAX package, on the CPU, at
``reduce_config`` (a self-attention layer and a cross layer, 8 modality
tokens of width 32).

Parameters come from ``japi.init_params(PRNGKey(0))`` through
``params_from_numpy``; tokens and modality features are drawn once with
numpy from a seed and reach both packages.  Tolerances are those of
tests/test_torch_models.py, with both packages' ``ACT_DTYPE`` set to f32:
2e-4 for the forward and the loss (the same arithmetic in another order
of f32 additions), every gradient leaf within rms(diff) <= 1e-4 rms(JAX)
(tests/test_torch_train.py), 5e-3 for decode (its self-attention caches
are bf16 in both packages); in bf16 the port's logits lie within twice
JAX's own bf16 error.

* ``param_shapes``, ``forward`` (with ``modality`` and, trap 2 of the
  reference, without it: the cross layers then attend over the text,
  non-causal, with rope), ``loss_fn`` and its gradients (with
  ``batch["modality"]``, whole and split into microbatches), the cross
  caches of ``init_decode_state(modality=)`` and three decode steps equal
  JAX's;
* trap 1: JAX's decode takes the cross K and V of the normed memory where
  its prefill takes the raw memory, so decode does not reproduce prefill;
  the port's gap between the two equals JAX's;
* non-causal ``grouped_attend`` with T != S takes the flash dispatch and
  equals JAX's; the prefill step takes ``batch["modality"]``;
* ``bench.serve.layer_check`` reads the cross layer apart from the self
  layer, and ``chip_smoke``'s dropped-tile control reads above ROW_TOL on
  a non-causal layer with T != S.
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
from repro.models import api as japi, attention as jattn
from repro.train import train_step as jts
from repro_torch.bench import serve as bench_serve
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import ops
from repro_torch.models import api, attention as attn, lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import train_step as ts
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llama-3.2-vision-90b"
FWD_TOL, DECODE_TOL, GRAD_RMS = 2e-4, 5e-3, 1e-4


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = jred(jget(ARCH)), reduce_config(get_config(ARCH))
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    mod = rng.standard_normal(
        (2, cfg.num_modality_tokens, cfg.modality_dim)).astype(np.float32)
    return jcfg, cfg, jp, tp, toks, mod


def _set_act(monkeypatch, name):
    monkeypatch.setattr(jlm, "ACT_DTYPE", {"f32": jnp.float32,
                                           "bf16": jnp.bfloat16}[name])
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


def _forward(pair, with_modality=True):
    jcfg, cfg, jp, tp, toks, mod = pair
    jkw = {"modality": jnp.asarray(mod)} if with_modality else {}
    tkw = {"modality": torch.from_numpy(mod)} if with_modality else {}
    jl, _ = jax.jit(lambda p, t: japi.forward(jcfg, p, t, remat=False,
                                              **jkw))(jp, jnp.asarray(toks))
    tl, aux = api.forward(cfg, tp, torch.from_numpy(toks).long(), **tkw)
    assert float(aux) == 0.0 and tl.shape == (*toks.shape, cfg.vocab_size)
    return _j(jl), tl.float().numpy()


def test_init_params_has_jax_tree_and_shapes(pair):
    """The port builds JAX's tree: ``mod_proj`` and the cross sublayer's
    ``norm``, ``wq``, ``wk``, ``wv``, ``wo``."""
    jcfg, cfg, jp, _, _, _ = pair
    want = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert api.param_shapes(cfg) == want
    assert "mod_proj" in want and "s0_cross" in want["groups"]["b1_cross_mlp"]
    tp = api.init_params(cfg, torch.Generator().manual_seed(0),
                         dtype=torch.bfloat16, device="cpu")
    assert lm.tree_map(lambda t: tuple(t.shape), tp) == want


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


def test_forward_without_modality_matches_jax(pair, f32):
    """Trap 2: with no ``modality`` the cross layer still runs, as
    non-causal self-attention with rope over the text; its logits are
    not those of the forward with modality."""
    jl, tl = _forward(pair, with_modality=False)
    np.testing.assert_allclose(tl, jl, atol=FWD_TOL, rtol=FWD_TOL)
    jm, _ = _forward(pair)
    assert np.abs(jm - jl).max() > 100 * FWD_TOL


@pytest.mark.parametrize("microbatches", [1, 2])
def test_loss_and_grads_match_jax(pair, f32, microbatches):
    """``loss_fn`` reads ``batch["modality"]``, and the microbatch split
    slices it with the tokens."""
    jcfg, cfg, jp, tp, toks, mod = pair
    b = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
         "modality": mod}
    jl, jg = jax.jit(lambda p, bb: jts._loss_and_grads(
        jcfg, p, bb, microbatches))(jp, {k: jnp.asarray(v)
                                          for k, v in b.items()})
    tl, tg = ts._loss_and_grads(cfg, tp, {k: torch.from_numpy(v)
                                          for k, v in b.items()},
                                microbatches)
    np.testing.assert_allclose(float(tl), float(jl), rtol=FWD_TOL)
    flat_t, flat_j = leaves(tg), jax.tree.leaves(jg)
    assert len(flat_t) == len(flat_j)
    for a, j in zip(flat_t, flat_j):
        assert a.shape == j.shape
        assert _rel_rms(a.numpy(), j) <= GRAD_RMS
    assert float(np.abs(tg["mod_proj"].numpy()).max()) > 0


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
    return js, ts_, out


def test_cross_caches_and_decode_match_jax(pair, f32):
    """``init_decode_state(modality=)`` fills the cross caches as JAX's
    ``_precompute_cross`` does (K and V of the normed memory, in
    ACT_DTYPE); three decode steps' logits equal JAX's."""
    jcfg, cfg, jp, tp, toks, mod = pair
    js = japi.init_decode_state(jcfg, jp, 2, 8, modality=jnp.asarray(mod))
    ts_ = api.init_decode_state(cfg, tp, 2, 8,
                                modality=torch.from_numpy(mod))
    assert lm.tree_map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                       ts_) == jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)), js)
    for kv in ("k", "v"):
        got = ts_["caches"]["b1_cross_mlp"]["s0_cross"][kv].numpy()
        want = _j(js["caches"]["b1_cross_mlp"]["s0_cross"][kv])
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL)
    for jl, tl in _decode_both(pair, 3)[2]:
        np.testing.assert_allclose(tl, jl, atol=DECODE_TOL, rtol=DECODE_TOL)


def test_prefill_decode_gap_equals_jax(pair, f32):
    """Trap 1: JAX's prefill takes the cross K and V of the raw memory,
    its decode those of ``rmsnorm(mem, norm)``, so teacher-forced decode
    departs from the prefill logits.  The port departs by the same gap,
    within the decode tolerance, and the gap is not small."""
    jcfg, cfg, jp, tp, toks, mod = pair
    B, S = 1, 8
    toks_, mod_ = toks[:B, :S], mod[:B]
    full, _ = api.forward(cfg, tp, torch.from_numpy(toks_).long(),
                          modality=torch.from_numpy(mod_))
    jfull, _ = japi.forward(jcfg, jp, jnp.asarray(toks_),
                            modality=jnp.asarray(mod_), remat=False)
    _, _, steps = _decode_both((jcfg, cfg, jp, tp, toks_, mod_), S, B=B,
                               seq=S)
    gap = np.concatenate([t for _, t in steps], 1) - full.numpy()
    jgap = np.concatenate([j for j, _ in steps], 1) - _j(jfull)
    assert np.abs(jgap).max() > 10 * DECODE_TOL
    np.testing.assert_allclose(gap, jgap, atol=DECODE_TOL, rtol=DECODE_TOL)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("S,T", [(48, 20), (20, 48)])
def test_noncausal_grouped_attend_takes_flash_and_matches_jax(
        bf16, S, T, monkeypatch):
    """Non-causal full-sequence attention with T != S (cross-attention)
    goes to the flash dispatch, non-causal, and equals JAX's chunked
    ``grouped_attend`` (f32 within 2e-5, bf16 within 2e-2)."""
    B, K, G, hd = 2, 2, 3, 16
    rng = np.random.default_rng(S * T)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, K, G, hd), (B, T, K, hd), (B, T, K, hd))]
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    if bf16:
        arrs = [_j(jnp.asarray(a, jnp.bfloat16)) for a in arrs]
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, *, causal, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return real(q, k, v, causal=causal, **kw)
    monkeypatch.setattr(ops, "flash_attention", spy)
    got = attn.grouped_attend(*(torch.from_numpy(a).to(tdt) for a in arrs),
                              causal=False)
    want = jattn.grouped_attend(*(jnp.asarray(a, jdt) for a in arrs),
                                causal=False)
    assert calls == [((B, S, K * G, hd), (B, T, K, hd), False)]
    tol = 2e-2 if bf16 else 2e-5
    np.testing.assert_allclose(got.float().numpy(), _j(want), atol=tol,
                               rtol=tol)


def test_prefill_step_takes_the_modality(pair):
    """``build_prefill_step`` passes ``batch["modality"]`` to the model: its
    token is the argmax of the forward with modality."""
    _, cfg, _, tp, toks, mod = pair
    t, m = torch.from_numpy(toks).long(), torch.from_numpy(mod)
    nxt = ts.build_prefill_step(cfg)(tp, {"tokens": t, "modality": m})
    logits, _ = api.forward(cfg, tp, t, modality=m)
    assert torch.equal(nxt, logits[:, -1:].argmax(-1))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_layer_check_reads_the_cross_layer():
    """The serve runner's layer check reads the self layer's causal call
    and the cross layer's non-causal one (T = 160 memory rows, S = 256),
    both 0 on the CPU, where both paths are plain; with chip_smoke's
    faulty plain attention (a key tile dropped) each reads above ROW_TOL,
    the cross layer's too."""
    smoke = _chip_smoke()
    cfg = reduce_config(get_config(ARCH))
    cfg = type(cfg)(**{**cfg.__dict__, "num_modality_tokens": 160})
    params = bench_serve.weights(cfg, device="cpu")
    tokens = bench_serve.prompt(cfg, 1, 256, torch.device("cpu"))
    mod = bench_serve.modality(cfg, 1, torch.device("cpu"))
    assert mod.shape == (1, 160, cfg.modality_dim)
    got = bench_serve.layer_check(cfg, params, tokens, modality=mod)
    assert got["kinds"] == ["flash_attention", "flash_noncausal"]
    assert got["per_layer"] == [0.0, 0.0]
    with smoke.faulty_plain("flash_attention"):
        bad = bench_serve.layer_check(cfg, params, tokens, modality=mod)
    assert min(bad["per_layer"]) > smoke.ROW_TOL
