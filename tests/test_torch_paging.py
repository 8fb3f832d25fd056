"""The port's KV block codec and paged engine against the JAX package's, on
the CPU.

* **codec**: on the same decode state (bf16 caches, from JAX's decode steps
  carried across as numpy) ``PagedKV.extract_blocks`` gives JAX's packed
  words, word for word; inserting them into a zeroed slot restores every
  leaf bit for bit, as JAX's insert does; a state with ``"pre"`` and
  sequence-free (aux) leaves packs as JAX packs it; and ``PagedKV`` refuses
  what JAX refuses.
* **engine**: with both packages' activations in f32, the paged engine's
  tokens equal the JAX paged engine's at hot sizes 1, 3 and all-local, and
  blocking all-cold; so do its store counters, its tiered transport
  counters and ``fabric_stats()["tiers"]``; the slot lock words return to
  0; the KV blocks agree within bf16 rounding (their bits follow each
  package's own f32 arithmetic).  mamba2, whose state has no sequence
  leaf, raises JAX's ``ValueError``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.lm as jlm
from repro.configs import get_config as jget, reduce_config as jred
from repro.models import api as japi
from repro.serving import PagedKV as JPagedKV
from repro.serving import Request as JRequest, ServeEngine as JEngine
from repro_torch.configs import get_config, reduce_config
from repro_torch.models import api, lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import PagedKV, Request, ServeEngine
from repro_torch.tree import leaves, tree_map

SLOTS, SEQ, BK = 2, 32, 8


@pytest.fixture(scope="module")
def glm4():
    jcfg, cfg = jred(jget("glm4-9b")), reduce_config(get_config("glm4-9b"))
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x):
    """A leaf's raw bits as a numpy array, from either package."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        x = x.numpy()
    return np.atleast_1d(np.asarray(x)).view(np.uint8)


def _words(x):
    return (x.numpy().view(np.uint32) if isinstance(x, torch.Tensor)
            else np.asarray(x))


@pytest.fixture(scope="module")
def decoded(glm4):
    """A JAX decode state after 10 steps (bf16 caches), and its copy."""
    jcfg, _, jp, _ = glm4
    state = japi.init_decode_state(jcfg, jp, SLOTS, SEQ)
    step = jax.jit(lambda p, s, t: japi.decode_step(jcfg, p, s, t))
    toks = np.random.default_rng(0).integers(0, 256, (10, SLOTS, 1))
    for t in toks:
        _, state = step(jp, state, jnp.asarray(t, jnp.int32))
    return state, jax.tree.map(_to_torch, state)


def test_codec_words_equal_jax(decoded):
    jstate, tstate = decoded
    jkv = JPagedKV(jstate, slots=SLOTS, max_seq=SEQ, block_tokens=BK)
    kv = PagedKV(tstate, slots=SLOTS, max_seq=SEQ, block_tokens=BK)
    assert (kv.block_words, kv.aux_words, kv.blocks_per_slot) == \
        (jkv.block_words, jkv.aux_words, jkv.blocks_per_slot)
    assert [(p.idx, p.shape, p.batch_axis, p.seq_axis, p.words)
            for p in kv.paged] == \
        [(p.idx, p.shape, p.batch_axis, p.seq_axis, p.words)
         for p in jkv.paged]
    for slot in range(SLOTS):
        js = list(range(kv.blocks_per_slot))
        np.testing.assert_array_equal(
            _words(kv.extract_blocks(tstate, slot, js)),
            _words(jkv.extract_blocks(jstate, slot, js)))
        np.testing.assert_array_equal(
            _words(kv.extract_block(tstate, slot, 1)),
            _words(jkv.extract_block(jstate, slot, 1)))


def test_codec_round_trip_bit_exact(decoded):
    jstate, tstate = decoded
    kv = PagedKV(tstate, slots=SLOTS, max_seq=SEQ, block_tokens=BK)
    jkv = JPagedKV(jstate, slots=SLOTS, max_seq=SEQ, block_tokens=BK)
    rows = kv.extract_blocks(tstate, 1, [0, 1])
    work = tree_map(torch.clone, tstate)
    kv.zero_slot(work, 1)
    assert not any(bool(x[:, 1].any()) for x in leaves(work["caches"]))
    kv.insert_blocks(work, 1, [0, 1], rows)
    jwork = jkv.insert_blocks(jkv.zero_slot(jstate, 1), 1, [0, 1],
                              jkv.extract_blocks(jstate, 1, [0, 1]))
    for a, b, c in zip(leaves(work), leaves(tstate),
                       jax.tree_util.tree_leaves(jwork)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
        np.testing.assert_array_equal(_bits(a), _bits(c))


def test_codec_pre_and_aux_leaves_equal_jax():
    """A state with a ``"pre"`` subtree and sequence-free per-slot leaves
    (bf16, f32, int8) packs its blocks and aux pages as JAX does, and the
    round trip is bit-exact."""
    rng = np.random.default_rng(5)
    G = 2
    tmpl = {"caches": {"k": rng.standard_normal((G, SLOTS, SEQ, 3)),
                       "conv": rng.standard_normal((G, SLOTS, 3, 5)),
                       "ssm": rng.standard_normal((G, SLOTS, 2, 2))},
            "pre": {"x": rng.standard_normal((SLOTS, SEQ, 3)),
                    "h": rng.integers(-100, 100, (SLOTS, 7))},
            "pos": np.int32(3)}
    dtypes = {"k": jnp.bfloat16, "conv": jnp.bfloat16, "ssm": np.float32,
              "x": np.float32, "h": np.int8}

    def cast(path, a):
        key = str(getattr(path[-1], "key", ""))
        return np.asarray(a, dtypes.get(key, np.asarray(a).dtype))
    jstate = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(cast(p, a)), tmpl)
    tstate = jax.tree.map(_to_torch, jstate)
    jkv = JPagedKV(jstate, slots=SLOTS, max_seq=SEQ, block_tokens=BK)
    kv = PagedKV(tstate, slots=SLOTS, max_seq=SEQ, block_tokens=BK)
    assert (kv.block_words, kv.aux_words) == (jkv.block_words,
                                              jkv.aux_words)
    assert len(kv.aux) == 3 and len(kv.paged) == 2
    np.testing.assert_array_equal(_words(kv.extract_aux(tstate, 1)),
                                  _words(jkv.extract_aux(jstate, 1)))
    np.testing.assert_array_equal(
        _words(kv.extract_blocks(tstate, 0, [2, 3])),
        _words(jkv.extract_blocks(jstate, 0, [2, 3])))
    work = tree_map(torch.clone, tstate)
    kv.zero_slot(work, 1)
    kv.insert_aux(work, 1, kv.extract_aux(tstate, 1))
    kv.insert_blocks(work, 1, range(kv.blocks_per_slot),
                     kv.extract_blocks(tstate, 1,
                                       range(kv.blocks_per_slot)))
    for a, b in zip(leaves(work), leaves(tstate)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("case", ["block", "subtree", "slots", "structure"])
def test_pagedkv_refuses_as_jax(case):
    def good(mk, dt):
        return {"caches": {"k": mk((1, 2, 16, 4), dt)},
                "pos": mk((), None)}
    tgood = good(lambda s, d: torch.zeros(s, dtype=d or torch.int32),
                 torch.bfloat16)
    jgood = good(lambda s, d: jnp.zeros(s, d or jnp.int32), jnp.bfloat16)
    cases = {
        "block": lambda P, g: P(g, slots=2, max_seq=16, block_tokens=5),
        "subtree": lambda P, g: P({"mystery": g["caches"]["k"][0]},
                                  slots=2, max_seq=16, block_tokens=4),
        "slots": lambda P, g: P(g, slots=3, max_seq=16, block_tokens=4),
    }
    if case == "structure":
        kv = PagedKV(tgood, slots=2, max_seq=16, block_tokens=4)
        jkv = JPagedKV(jgood, slots=2, max_seq=16, block_tokens=4)
        with pytest.raises(ValueError, match="structure changed"):
            jkv.extract_block({"caches": jgood["caches"]}, 0, 0)
        with pytest.raises(ValueError, match="structure changed"):
            kv.extract_block({"caches": tgood["caches"]}, 0, 0)
        return
    with pytest.raises(ValueError) as jerr:
        cases[case](JPagedKV, jgood)
    with pytest.raises(ValueError) as terr:
        cases[case](PagedKV, tgood)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------- the engine ---

def _reqs(R):
    return [R(rid=i, prompt=np.array([2 + i, 5, 7][:2 + i % 2], np.int32),
              max_new_tokens=3 + i % 2) for i in range(5)]


@pytest.fixture(scope="module")
def jax_f32(glm4):
    """A config object of the JAX engine's own: its decode step is jitted
    once per config object, traced here with f32 activations."""
    return dataclasses.replace(glm4[0])


@pytest.mark.parametrize("kw", [dict(hot_blocks=1), dict(hot_blocks=3),
                                dict(hot_frac=1.0),
                                dict(hot_blocks=1, prefetch=False)],
                         ids=["hot1", "hot3", "all_local",
                              "blocking_all_cold"])
def test_paged_engine_equals_jax_f32(glm4, jax_f32, kw, monkeypatch):
    _, cfg, jp, tp = glm4
    monkeypatch.setattr(jlm, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(lm, "ACT_DTYPE", torch.float32)
    shape = dict(slots=2, max_seq=64, paged=True, block_tokens=8,
                 max_resident=4, **kw)
    je = JEngine(jax_f32, jp, **shape)
    te = ServeEngine(cfg, tp, device="cpu", **shape)
    jdone, tdone = je.run(_reqs(JRequest)), te.run(_reqs(Request))
    je.quiesce()
    te.quiesce()
    assert len(tdone) == 5
    assert {r.rid: r.out for r in tdone} == {r.rid: r.out for r in jdone}
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert te.store.stats() == je.store.stats()
    assert te.store.resident_blocks() == je.store.resident_blocks()
    assert te.allocator.free == je.allocator.free
    assert not bool(te.slot_words.any())
    assert not np.asarray(je.slot_words).any()
    jst, tst = je.db.fabric_stats(), te.db.fabric_stats()
    for verb in ("read_cold", "write_cold", "read_hot", "write_hot", "cas",
                 "write", "tiers"):
        assert tst.get(verb) == jst.get(verb), verb
    if kw.get("hot_frac") == 1.0:
        assert "read_cold" not in tst and "write_cold" not in tst
    else:
        c = te.store.counters
        assert c["misses"] + c["prefetched"] > 0 and c["writebacks"] > 0
    cold = te.store.cold.numpy().view(np.int16).view(np.uint16)
    jcold = np.asarray(je.store.cold).view(np.uint16)
    as_f32 = [(np.asarray(x, np.uint32) << 16).view(np.float32)
              for x in (cold, jcold)]
    np.testing.assert_allclose(*as_f32, rtol=2 ** -7, atol=1e-6)


def test_paged_mamba2_raises_as_jax():
    jcfg, cfg = jred(jget("mamba2-370m")), reduce_config(
        get_config("mamba2-370m"))
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    with pytest.raises(ValueError) as jerr:
        JEngine(jcfg, jp, slots=2, max_seq=64, paged=True, block_tokens=8)
    with pytest.raises(ValueError) as terr:
        ServeEngine(cfg, tp, slots=2, max_seq=64, paged=True, block_tokens=8,
                    device="cpu")
    assert str(terr.value) == str(jerr.value) == \
        "paged mode needs at least one seq-axis leaf"
