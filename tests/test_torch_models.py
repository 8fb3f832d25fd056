"""The port's model stack against the JAX package, on the CPU, for the
reduced glm4-9b (dense GQA) and mamba2-370m (SSM).

* ``init_params`` builds JAX's tree with JAX's shapes;
* with JAX's parameters carried across by ``params_from_numpy``,
  ``forward`` and a sequence of ``decode_step``s match JAX's logits:
  in f32 (both packages' ``ACT_DTYPE`` set to float32 by the test) within
  2e-4 for the forward (the same arithmetic in another order of f32
  additions) and 5e-3 for decode (its KV cache is bf16 in both, so an f32
  value a hair either side of a bf16 rounding boundary lands on another
  bf16 value); in bf16 the port may differ from JAX's bf16 logits by no
  more than twice JAX's own bf16 error (JAX's bf16 logits against its f32
  ones on the same inputs): each package's bf16 logits lie within their
  rounding of the f32 logits;
* the port's own prefill-decode equivalence, as
  tests/test_archs_smoke.py:63-85 holds JAX's, on the same weights and
  tokens, in bf16 within 5e-2 (JAX holds 3e-2, but there prefill and
  decode share the chunked attention; in the port prefill takes the flash
  path, whose probabilities round elsewhere);
* every other family runs forward and decode: the other dense configs,
  and the VLM and whisper with a modality batch (their parity with JAX is
  in tests/test_torch_vlm.py and tests/test_torch_encdec.py; the MoE, MLA
  and hybrid families' in tests/test_torch_moe.py);
* ``params_from_numpy`` checks names and shapes, on the dense tree and on
  whisper's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.lm as jlm
from repro.configs import get_config as jget, reduce_config as jred
from repro.models import api as japi
from repro_torch.configs import ARCH_IDS, get_config, reduce_config
from repro_torch.models import api, lm
from repro_torch.models.convert import params_from_numpy

ARCHS = ["glm4-9b", "mamba2-370m"]
DENSE = {"glm4-9b", "mamba2-370m", "starcoder2-15b", "granite-20b",
         "granite-34b"}
MODALITY = ["llama-3.2-vision-90b", "whisper-base"]
PORTED = DENSE | set(MODALITY) | {"llama4-maverick-400b-a17b",
                                  "deepseek-v2-236b", "jamba-1.5-large-398b"}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg, cfg = jred(jget(arch)), reduce_config(get_config(arch))
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)
    return jcfg, cfg, jp, tp, toks


@pytest.fixture
def act(monkeypatch):
    """Set both packages' activation dtype: act("f32") or act("bf16")."""
    def set_(name):
        monkeypatch.setattr(jlm, "ACT_DTYPE", {"f32": jnp.float32,
                                               "bf16": jnp.bfloat16}[name])
        monkeypatch.setattr(lm, "ACT_DTYPE", {"f32": torch.float32,
                                              "bf16": torch.bfloat16}[name])
    return set_


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_jax_tree_and_shapes(arch):
    jp = jax.eval_shape(lambda: japi.init_params(
        jred(jget(arch)), jax.random.PRNGKey(0)))
    cfg = reduce_config(get_config(arch))
    tp = api.init_params(cfg, torch.Generator().manual_seed(0),
                         dtype=torch.bfloat16, device="cpu")
    want = [(k, tuple(v.shape)) for k, v in _leaves(jp)]
    assert [(k, tuple(v.shape)) for k, v in _leaves(tp)] == want
    assert [(k, v) for k, v in _leaves(api.param_shapes(cfg))] == want
    assert all(v.dtype == torch.bfloat16 for _, v in _leaves(tp))
    assert float(tp["embed"].float().std()) == pytest.approx(0.02, rel=0.1)


def _j(x):
    return np.asarray(x, np.float32)


def _t(x):
    return x.float().numpy()


def _forward_both(pair):
    jcfg, cfg, jp, tp, toks = pair
    jl, _ = japi.forward(jcfg, jp, jnp.asarray(toks), remat=False)
    tl, aux = api.forward(cfg, tp, torch.from_numpy(toks).long())
    assert aux == 0.0 and tl.shape == (2, 64, cfg.vocab_size)
    return _j(jl), _t(tl)


def test_forward_matches_jax_f32(pair, act):
    act("f32")
    jl, tl = _forward_both(pair)
    np.testing.assert_allclose(tl, jl, atol=2e-4, rtol=2e-4)


def test_forward_bf16_within_jax_own_bf16_rounding(pair, act):
    act("f32")
    ref32, _ = _forward_both(pair)
    act("bf16")
    jl, tl = _forward_both(pair)
    assert np.isfinite(tl).all()
    assert np.abs(tl - jl).max() <= 2 * np.abs(jl - ref32).max()


def _decode_both(pair, steps=10):
    jcfg, cfg, jp, tp, toks = pair
    js = japi.init_decode_state(jcfg, jp, 2, 16)
    ts = api.init_decode_state(cfg, tp, 2, 16)
    out = []
    for t in range(steps):
        a, js = japi.decode_step(jcfg, jp, js, jnp.asarray(toks[:, t:t + 1]))
        b, ts = api.decode_step(cfg, tp, ts,
                                torch.from_numpy(toks[:, t:t + 1]).long())
        assert int(ts["pos"]) == t + 1
        out.append((_j(a), _t(b)))
    return out


def test_decode_steps_match_jax_f32(pair, act):
    act("f32")
    for jl, tl in _decode_both(pair):
        np.testing.assert_allclose(tl, jl, atol=5e-3, rtol=5e-3)


def test_decode_steps_bf16_within_jax_own_bf16_rounding(pair, act):
    act("f32")
    ref32 = [jl for jl, _ in _decode_both(pair, steps=6)]
    act("bf16")
    got = _decode_both(pair, steps=6)
    for (jl, tl), j32 in zip(got, ref32):
        assert np.isfinite(tl).all()
        assert np.abs(tl - jl).max() <= 2 * np.abs(jl - j32).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_equivalence(arch):
    """Teacher-forced decode reproduces the full-sequence logits, on the
    weights and tokens tests/test_archs_smoke.py:63-85 holds the JAX
    package to, with its tolerance."""
    jcfg, cfg = jred(jget(arch)), reduce_config(get_config(arch))
    key = jax.random.PRNGKey(0)
    params = params_from_numpy(cfg, jax.tree.map(
        np.asarray, japi.init_params(jcfg, key)), device="cpu")
    B, S = 1, 8
    toks = torch.from_numpy(np.asarray(jax.random.randint(
        key, (B, S), 0, cfg.vocab_size))).long()
    full, _ = api.forward(cfg, params, toks)
    state = api.init_decode_state(cfg, params, B, S)
    outs = []
    for t in range(S):
        logits, state = api.decode_step(cfg, params, state, toks[:, t:t + 1])
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1).float(), full.float(),
                               atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("arch", sorted(DENSE - set(ARCHS)) + MODALITY)
def test_other_dense_configs_run(arch):
    """The dense families with a GELU MLP (starcoder2, granite) and MQA
    run forward and decode; the VLM and whisper with a modality batch,
    their decode from ``init_decode_state(modality=)``."""
    assert set(ARCH_IDS) <= PORTED
    cfg = reduce_config(get_config(arch))
    params = api.init_params(cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16))
    kw = {}
    if cfg.modality_dim:
        kw["modality"] = torch.randn(2, cfg.num_modality_tokens,
                                     cfg.modality_dim)
    logits, _ = api.forward(cfg, params, toks, **kw)
    assert logits.shape == (2, 16, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())
    state = api.init_decode_state(cfg, params, 2, 8, **kw)
    logits, state = api.decode_step(cfg, params, state, toks[:, :1])
    assert bool(torch.isfinite(logits.float()).all())


def _check_tree(arch, short, gone):
    """A leaf of the wrong shape (``short``) or a tree missing a key
    (``gone``) is refused by name; the right tree carries across."""
    cfg = reduce_config(get_config(arch))
    tree = jax.tree.map(np.asarray, japi.init_params(
        jred(jget(arch)), jax.random.PRNGKey(0)))
    bad = dict(tree, **{short: tree[short][:, :8]})
    with pytest.raises(ValueError, match=short):
        params_from_numpy(cfg, bad, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(cfg, {k: v for k, v in tree.items()
                                if k != gone}, device="cpu")
    p = params_from_numpy(cfg, tree, dtype=torch.bfloat16, device="cpu")
    assert api.param_shapes(cfg) == lm.tree_map(lambda t: tuple(t.shape), p)
    return p


def test_params_from_numpy_checks_the_tree():
    p = _check_tree("glm4-9b", "embed", "lm_head")
    assert p["groups"]["b0_attn_mlp"]["s0_attn"]["wq"].dtype == torch.bfloat16


def test_params_from_numpy_checks_the_whisper_tree():
    """Whisper's encoder leaves: ``enc_pos`` cut to fewer frames,
    ``enc_norm`` left out."""
    p = _check_tree("whisper-base", "enc_pos", "enc_norm")
    assert p["enc_groups"]["b0_attn_mlp"]["s0_attn"]["wq"].dtype \
        == torch.bfloat16
