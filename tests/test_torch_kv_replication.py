"""KV-head replication under a tensor-parallel policy
(``models/attention.py``: ``tp_size``, ``kv_heads_eff``,
``_repeat_kv_weight``) against the JAX package's.

* ``kv_heads_eff`` equals JAX's for every config with attention, full and
  at ``reduce_config``, under (1, 1), (2, 4), (4, 2) and (1, 8) host
  meshes (JAX's need eight devices: they run once, in a subprocess that
  sets ``--xla_force_host_platform_device_count=8`` before it imports
  ``jax``, and print every count as JSON), and at the production mesh's
  (16, 16) shape, JAX's rule read with its ``tp_size`` at 16;
* a ``reduce_config(glm4-9b)`` f32 forward (4 heads, 2 KV heads) under a
  (1, 4) policy runs its K/V projections at 4 heads and equals the
  forward with no policy and JAX's f32 forward within 2e-4 (the f32
  tolerance of tests/test_torch_models.py): repeated heads change no
  value.  (2, 4) and (1, 8) policies run it too;
* the roofline's ``StepCounter`` counts the K/V projection products of
  that prefill step at kve heads: kve / kv times the count with no
  policy, and every other product as before.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jattn
import repro.models.lm as jlm
from repro.configs import get_config as jget, reduce_config as jred
from repro.models import api as japi
from repro_torch.configs import ARCH_IDS, get_config, reduce_config
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import api, attention, lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.sharding import make_policy, set_policy
from repro_torch.train import train_step as ts

ROOT = Path(__file__).resolve().parents[1]
MESHES = ((1, 1), (2, 4), (4, 2), (1, 8))
ATTN_ARCHS = tuple(a for a in ARCH_IDS if get_config(a).num_heads > 0)
B, S = 2, 64

_ORACLE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.configs import get_config, reduce_config
from repro.launch.mesh import make_host_mesh
from repro.models.attention import kv_heads_eff
from repro.sharding import make_policy, set_policy

out = {}
for shape in json.loads(sys.argv[1]):
    policy = make_policy(make_host_mesh(*shape))
    with set_policy(policy):
        for arch in json.loads(sys.argv[2]):
            cfg = get_config(arch)
            out[f"{arch}:{shape[0]}x{shape[1]}"] = kv_heads_eff(cfg)
            out[f"{arch}-smoke:{shape[0]}x{shape[1]}"] = kv_heads_eff(
                reduce_config(cfg))
print("KVE " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_kve():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _ORACLE, json.dumps(MESHES),
                        json.dumps(ATTN_ARCHS)], env=env,
                       capture_output=True, text=True, timeout=300)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("KVE ")]
    assert line, r.stderr[-3000:]
    return json.loads(line[0][4:])


def _port_kve(cfg, mesh):
    with set_policy(None if mesh is None else make_policy(mesh)):
        return attention.kv_heads_eff(cfg)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_kv_heads_eff_equals_jax_s_on_host_meshes(jax_kve, shape):
    mesh = make_host_mesh(*shape, device="cpu")
    got, want = {}, {}
    for arch in ATTN_ARCHS:
        for name, cfg in ((arch, get_config(arch)),
                          (f"{arch}-smoke", reduce_config(get_config(arch)))):
            key = f"{name}:{shape[0]}x{shape[1]}"
            got[key], want[key] = _port_kve(cfg, mesh), jax_kve[key]
    assert got == want
    if shape == (2, 4):     # glm4 (2 KV heads of 32) is replicated to 4
        assert got["glm4-9b:2x4"] == 4 and got["glm4-9b-smoke:2x4"] == 4
    if shape == (1, 8):
        assert got["glm4-9b:1x8"] == 8 and got["granite-34b:1x8"] == 8


def test_kv_heads_eff_equals_jax_s_on_the_production_mesh(monkeypatch):
    """(16, 16): 256 devices, so JAX's rule is read with its tp_size at the
    mesh's 'model' axis."""
    mesh = make_production_mesh()
    monkeypatch.setattr(jattn, "tp_size", lambda: mesh.shape["model"])
    got, want = {}, {}
    for arch in ATTN_ARCHS:
        for cfg, jcfg in ((get_config(arch), jget(arch)),
                          (reduce_config(get_config(arch)),
                           jred(jget(arch)))):
            got[cfg.name], want[cfg.name] = (_port_kve(cfg, mesh),
                                             jattn.kv_heads_eff(jcfg))
    assert got == want
    assert got["glm4-9b"] == 16 and got["starcoder2-15b"] == 16
    # no policy, or a policy without a mesh: tp 1, no replication
    assert {a: _port_kve(get_config(a), None) for a in ATTN_ARCHS} == {
        a: get_config(a).num_kv_heads for a in ATTN_ARCHS}


def test_repeat_kv_weight_is_jax_s():
    w = np.random.default_rng(1).standard_normal((8, 2, 4)).astype(
        np.float32)
    for kve in (2, 4, 8):
        np.testing.assert_array_equal(
            attention._repeat_kv_weight(torch.from_numpy(w), 2, kve).numpy(),
            np.asarray(jattn._repeat_kv_weight(jnp.asarray(w), 2, kve)))


@pytest.fixture(scope="module")
def glm4():
    jcfg, cfg = jred(jget("glm4-9b")), reduce_config(get_config("glm4-9b"))
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, cfg, jp, tp, toks


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(jlm, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(lm, "ACT_DTYPE", torch.float32)


def _forward(cfg, params, toks, mesh_shape=None):
    policy = None if mesh_shape is None else make_policy(
        make_host_mesh(*mesh_shape, device="cpu"), shape_kind="prefill")
    seen = []
    orig = attention.grouped_attend

    def spy(q, k, v, **kw):
        seen.append((q.shape[2], k.shape[2]))
        return orig(q, k, v, **kw)

    attention.grouped_attend = spy
    try:
        with set_policy(policy), torch.no_grad():
            logits, _ = api.forward(cfg, params, torch.from_numpy(toks).long())
    finally:
        attention.grouped_attend = orig
    return logits.float().numpy(), seen


def test_forward_under_a_policy_equals_no_policy_and_jax(glm4, f32):
    jcfg, cfg, jp, tp, toks = glm4
    assert (cfg.num_heads, cfg.num_kv_heads) == (4, 2)
    jl, _ = japi.forward(jcfg, jp, jnp.asarray(toks), remat=False)
    jl = np.asarray(jl, np.float32)
    plain, seen = _forward(cfg, tp, toks)
    assert set(seen) == {(2, 2)}              # K groups of q, KV heads of k
    np.testing.assert_allclose(plain, jl, atol=2e-4, rtol=2e-4)
    for shape, kve in (((1, 4), 4), ((2, 4), 4), ((1, 8), 4)):
        got, seen = _forward(cfg, tp, toks, shape)
        # every attention layer ran with its K/V heads repeated to kve, so
        # that they divide over the mesh's 'model' axis where JAX's do
        assert seen and set(seen) == {(kve, kve)}, (shape, seen)
        np.testing.assert_allclose(got, plain, atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(got, jl, atol=2e-4, rtol=2e-4)


def _prefill_flops(cfg, policy=None) -> float:
    params = ts._meta(api.param_shapes(cfg))
    tokens = torch.zeros((B, S), dtype=torch.int32, device="meta")
    with set_policy(policy), roofline.StepCounter() as c:
        ts.build_prefill_step(cfg)(params, {"tokens": tokens})
    return c.totals()["flops"]


def test_step_counter_counts_kv_projections_at_kve_heads():
    cfg = reduce_config(get_config("glm4-9b"))
    kv, d, hd = cfg.num_kv_heads, cfg.d_model, cfg.hd
    none = _prefill_flops(cfg)
    for shape in ((1, 4), (1, 8)):
        policy = make_policy(make_host_mesh(*shape, device="meta"),
                             shape_kind="prefill")
        with set_policy(policy):
            kve = attention.kv_heads_eff(cfg)
        assert kve == 4
        # K and V: 2 B S d hd FLOP a head each, in every layer
        kv_proj = cfg.num_layers * 2 * 2 * B * S * d * hd * kv
        assert _prefill_flops(cfg, policy) - none == kv_proj * (kve / kv - 1)
