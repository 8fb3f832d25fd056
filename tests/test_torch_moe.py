"""The port's MoE and the families it brings (llama4's MoE, deepseek's MoE
with MLA and a dense first layer, jamba's hybrid) against the JAX
package, on the CPU, at ``reduce_config``.

The weights are drawn with numpy in JAX's tree (``jax.eval_shape`` of
its ``init_params``; the ``Mk`` scales) and reach both packages, the port
through ``params_from_numpy``.  With no sharding policy JAX's
``apply_moe`` runs its reference loop, the function the port holds.
Tolerances are those of tests/test_torch_models.py:6-19, with both
packages' ``ACT_DTYPE`` set to f32: 2e-4 for the forward, the MoE layer
and the loss (the same arithmetic in another order of f32 additions),
5e-3 for decode (its caches are bf16 in both packages, so a value a hair
either side of a bf16 rounding boundary lands on another bf16 value).

* ``_gates`` picks JAX's experts, ties to the lower id as
  ``jax.lax.top_k`` does, and ``aux_load_balance`` is JAX's;
* ``apply_moe`` (the packed experts for the full sequence, the reference
  loop for decode) equals JAX's, with shared experts and without;
* the packed experts equal the reference loop on the plain path, drop
  nothing when every token picks one expert, and pack each expert's rows
  together in arrival order;
* ``forward`` (logits and the summed aux), ``loss_fn`` (with
  ``router_aux_coef`` times the aux) and a run of ``decode_step`` equal
  JAX's for the three archs;
* the port's teacher-forced decode departs from its prefill logits as
  JAX's does from JAX's (tests/test_archs_smoke.py:63-85 holds that
  gap): the two gaps agree within the decode tolerance.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.lm as jlm
from repro.configs import get_config as jget, reduce_config as jred
from repro.models import api as japi, moe as jmoe
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import ref
from repro_torch.models import api, lm, moe
from repro_torch.models.convert import params_from_numpy

ARCHS = ["llama4-maverick-400b-a17b", "deepseek-v2-236b",
         "jamba-1.5-large-398b"]
FWD_TOL, DECODE_TOL = 2e-4, 5e-3


def numpy_params(jcfg, seed=0):
    """JAX's parameter tree drawn with numpy at the ``Mk`` scales: norms
    zero, the embedding 0.02, every other leaf 1/sqrt(its fan-in)."""
    shapes = jax.eval_shape(lambda: japi.init_params(
        jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def draw(path, sd):
        name = str(path[-1].key)
        if name.endswith("norm"):
            return np.zeros(sd.shape, np.float32)
        scale = 0.02 if name == "embed" else 1.0 / np.sqrt(
            sd.shape[-2] if len(sd.shape) >= 2 else sd.shape[0])
        return (rng.standard_normal(sd.shape) * scale).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg, cfg = jred(jget(arch)), reduce_config(get_config(arch))
    tree = numpy_params(jcfg)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(cfg, tree, device="cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    return jcfg, cfg, jp, tp, toks


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(jlm, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(lm, "ACT_DTYPE", torch.float32)


def _moe_layer(cfg, tree):
    """The first MoE sublayer's parameters of group 0."""
    for bname in sorted(tree["groups"]):
        for sname in sorted(tree["groups"][bname]):
            if sname.endswith("_moe"):
                return {k: v[0] for k, v in
                        tree["groups"][bname][sname].items()}
    raise AssertionError(f"{cfg.name} has no MoE sublayer")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_jax_tree_and_shapes(arch):
    """The port builds JAX's tree, ``pre`` and expert leaves included."""
    shapes = jax.eval_shape(lambda: japi.init_params(
        jred(jget(arch)), jax.random.PRNGKey(0)))
    want = jax.tree_util.tree_map_with_path(lambda p, s: tuple(s.shape),
                                            shapes)
    cfg = reduce_config(get_config(arch))
    assert api.param_shapes(cfg) == want
    tp = api.init_params(cfg, torch.Generator().manual_seed(0),
                         dtype=torch.bfloat16, device="cpu")
    assert lm.tree_map(lambda t: tuple(t.shape), tp) == want


@pytest.mark.parametrize("tie", [False, True])
def test_gates_match_jax_and_break_ties_to_the_lower_expert(tie):
    """With ``tie``, experts 1 and 2 (and 4 and 5) share a router column,
    so every token's probabilities tie between them; the port must pick
    JAX's ids, the lower of a tied pair first."""
    mcfg = reduce_config(get_config("deepseek-v2-236b")).moe
    mcfg = type(mcfg)(**{**mcfg.__dict__, "num_experts": 6, "top_k": 3})
    xt, w = _x((40, 16), 2), _x((16, 6), 3)
    if tie:
        w[:, 2], w[:, 5] = w[:, 1], w[:, 4]
    jv, ji, jp = jmoe._gates(mcfg, jnp.asarray(xt), jnp.asarray(w))
    tv, ti, tp = moe._gates(mcfg, torch.from_numpy(xt), torch.from_numpy(w))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6,
                               rtol=1e-6)
    if tie:
        assert ((ti == 1) | (ti == 2)).sum(-1).max() == 2 or \
            ((ti == 4) | (ti == 5)).sum(-1).max() == 2


def test_aux_load_balance_matches_jax():
    mcfg = reduce_config(get_config("jamba-1.5-large-398b")).moe
    xt, w = _x((64, 64), 4), _x((64, mcfg.num_experts), 5)
    want = jmoe.aux_load_balance(mcfg, jnp.asarray(xt), jnp.asarray(w))
    got = moe.aux_load_balance(mcfg, torch.from_numpy(xt),
                               torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("decode", [False, True], ids=["packed", "decode"])
def test_apply_moe_matches_jax(pair, decode):
    """One MoE layer of each arch (llama4 top-1 with a shared expert,
    deepseek top-2 with two, jamba top-2 with none), y and aux, in f32."""
    jcfg, cfg, _, _, _ = pair
    tree = numpy_params(jcfg)
    p = _moe_layer(cfg, tree)
    x = _x((2, 1 if decode else 24, cfg.d_model), 6)
    jy, jaux = jmoe.apply_moe(jcfg, jcfg.moe, jax.tree.map(jnp.asarray, p),
                              jnp.asarray(x), decode=decode)
    ty, taux = moe.apply_moe(cfg, cfg.moe, {k: torch.from_numpy(v)
                                           for k, v in p.items()},
                             torch.from_numpy(x), decode=decode)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=FWD_TOL,
                               rtol=FWD_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_experts_equal_the_reference_loop(pair, dtype):
    """The packed plain path computes the reference loop's function:
    within 1e-5 in f32; in bf16 each row within ``ROW_TOL`` (2^-6, the
    card's limit for the same comparison: a matmul over an expert's rows
    may round other than one over every token)."""
    from repro_torch.bench.serve import row_rel_err
    jcfg, cfg, _, _, _ = pair
    p = {k: torch.from_numpy(v).to(dtype)
         for k, v in _moe_layer(cfg, numpy_params(jcfg)).items()}
    x = torch.from_numpy(_x((3, 40, cfg.d_model), 7)).to(dtype)
    got = moe._moe_packed(cfg, cfg.moe, p, x, impl="plain")
    want = moe._moe_reference(cfg, cfg.moe, p, x)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert row_rel_err(got, want) <= 2 ** -6


def test_packing_drops_nothing_when_every_token_picks_one_expert(pair):
    """A router that sends every token's first choice to expert 0: its
    bucket holds all T tokens (cap T), and nothing drops."""
    jcfg, cfg, _, _, _ = pair
    p = {k: torch.from_numpy(v)
         for k, v in _moe_layer(cfg, numpy_params(jcfg)).items()}
    p["router"] = p["router"].clone()
    p["router"][:, 0] = 50.0
    x = torch.from_numpy(np.abs(_x((2, 20, cfg.d_model), 8)))
    _, idx, _ = moe._gates(cfg.moe, x.reshape(-1, cfg.d_model), p["router"])
    assert bool((idx[:, 0] == 0).all())
    torch.testing.assert_close(
        moe._moe_packed(cfg, cfg.moe, p, x, impl="plain"),
        moe._moe_reference(cfg, cfg.moe, p, x), atol=1e-5, rtol=1e-5)


def test_packed_rows_group_each_expert_in_arrival_order():
    """row = exclusive-cumsum(counts)[e] + rank: a permutation of the
    assignments, experts in ascending blocks, arrival order kept inside
    each (the stable binning of JAX's ``_radix_to_buffers``)."""
    T, E = 50, 7
    dest = torch.from_numpy(np.random.default_rng(9).integers(
        0, E, T * 2).astype(np.int32))
    slot, keep, _, counts = ref.rank(dest, E, T)
    assert bool(keep.all())
    ends = torch.cumsum(counts, 0)
    row = (ends - counts)[dest.long()] + slot - dest * T
    assert sorted(row.tolist()) == list(range(T * 2))
    packed = torch.empty_like(dest)
    packed[row.long()] = dest
    assert torch.equal(packed, dest.sort(stable=True).values)
    order = torch.empty_like(row)
    order[row.long()] = torch.arange(T * 2)
    for e in range(E):
        block = order[int(ends[e] - counts[e]):int(ends[e])]
        assert torch.equal(block, block.sort().values)


def test_forward_and_loss_match_jax(pair, f32):
    """Logits, the summed aux and the loss with its aux term, in f32."""
    jcfg, cfg, jp, tp, toks = pair
    jl, jaux = jax.jit(lambda p, t: japi.forward(jcfg, p, t, remat=False))(
        jp, jnp.asarray(toks))
    tl, taux = api.forward(cfg, tp, torch.from_numpy(toks).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=FWD_TOL,
                               rtol=FWD_TOL)
    assert float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=FWD_TOL)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jloss = jax.jit(partial(jlm.loss_fn, jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    tloss = api.loss_fn(cfg, tp, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=FWD_TOL)
    plain = api.loss_fn(cfg, tp, tb, aux_coef=0.0)
    np.testing.assert_allclose(float(tloss - plain),
                               cfg.moe.router_aux_coef * float(taux),
                               rtol=1e-3)


def test_decode_steps_match_jax(pair, f32):
    jcfg, cfg, jp, tp, toks = pair
    step = jax.jit(partial(japi.decode_step, jcfg))
    js = japi.init_decode_state(jcfg, jp, 2, 16)
    ts = api.init_decode_state(cfg, tp, 2, 16)
    assert lm.tree_map(lambda t: tuple(t.shape), ts) == jax.tree.map(
        lambda a: tuple(a.shape), js)
    for t in range(8):
        a, js = step(jp, js, jnp.asarray(toks[:, t:t + 1]))
        b, ts = api.decode_step(cfg, tp, ts,
                                torch.from_numpy(toks[:, t:t + 1]).long())
        assert int(ts["pos"]) == t + 1
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=DECODE_TOL,
                                   rtol=DECODE_TOL)


def test_prefill_decode_equivalence(pair, f32):
    """Teacher-forced decode (the reference loop, MLA's absorbed form)
    against the full-sequence logits (the packed experts, MLA
    decompressed): the port's gap between the two equals JAX's own, in
    f32, within the decode tolerance.  Both gaps are the bf16 caches'
    (up to 0.16 on these weights, where a cache's rounding moves a token
    to another expert); they agree to 1e-5.  In bf16 the port's prefill
    takes the flash path (f32 probabilities) where JAX's shares decode's
    chunked attention (bf16 probabilities), and routing turns that
    rounding into a different expert for some tokens, so a bf16 gap says
    nothing of the port's decode."""
    jcfg, cfg, jp, tp, toks = pair
    B, S = 1, 8
    toks = toks[:B, :S]
    full, _ = api.forward(cfg, tp, torch.from_numpy(toks).long())
    jfull, _ = jax.jit(lambda p, t: japi.forward(jcfg, p, t, remat=False))(
        jp, jnp.asarray(toks))
    step = jax.jit(partial(japi.decode_step, jcfg))
    state = api.init_decode_state(cfg, tp, B, S)
    js = japi.init_decode_state(jcfg, jp, B, S)
    outs, jouts = [], []
    for t in range(S):
        logits, state = api.decode_step(cfg, tp, state,
                                        torch.from_numpy(toks[:, t:t + 1])
                                        .long())
        a, js = step(jp, js, jnp.asarray(toks[:, t:t + 1]))
        outs.append(logits[:, 0])
        jouts.append(np.asarray(a)[:, 0])
    gap = (torch.stack(outs, 1) - full).numpy()
    jgap = np.stack(jouts, 1) - np.asarray(jfull)
    np.testing.assert_allclose(gap, jgap, atol=DECODE_TOL, rtol=DECODE_TOL)
