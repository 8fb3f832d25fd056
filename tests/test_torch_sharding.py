"""The port's sharding policy (``repro_torch.sharding``), the logical axes
of every parameter, and the shardings of ``train_step``, the optimizers
and ``NamPool`` against the JAX package's.

* ``make_policy``'s rules and ``resolve`` for every ``shape_kind``, both
  ``DECODE_TP`` settings, on a (data, model) and a (pod, data, model)
  mesh; ``param_pspec`` and ``constrain``;
* ``api.param_logical_axes`` for every config of ``repro_torch/configs``
  at ``reduce_config``, leaf by leaf by path;
* on a (2, 4) mesh, the partition specs of ``param_shardings``,
  ``opt_state_shardings`` (AdamW and Adafactor), ``batch_shardings``,
  ``decode_state_shardings`` and ``NamPool.shardings``, leaf by leaf.
  JAX's need eight devices: they run once, in a subprocess that sets
  ``--xla_force_host_platform_device_count=8`` before it imports ``jax``,
  and print every spec as JSON.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.sharding.policy as jpolicy
from repro.configs import get_config as jget, reduce_config as jreduce
from repro.models import api as japi
from repro_torch.configs import ARCH_IDS, get_config, reduce_config
from repro_torch.fabric.verbs import NamPool
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import api
from repro_torch.sharding import policy
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import make_optimizer

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("train", "prefill", "decode", "long_decode")
LOGICAL = [(n,) for n in policy.DEFAULT_RULES] + [
    ("batch", "seq_sharded", None), ("kv_batch", "kv_seq", "kv_heads", None),
    ("experts", "embed", None), (None, None), ("unknown",), ()]
BATCH, SEQ = 4, 16        # the decode state's and the batch's shapes
POOL = (("words", (64,), "uint32", None),
        ("kv", (8, 16, 4), "float32", ("kv_batch", "kv_seq", None)),
        ("w", (32, 8), "float32", ("embed", "ff")),
        ("odd", (3, 8), "float32", ("embed", "ff")))

_ORACLE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs import get_config, reduce_config
from repro.configs.base import ShapeCfg
from repro.fabric.verbs import NamPool
from repro.models import api
from repro.sharding import make_policy
from repro.train import train_step as ts
from repro.train.optimizer import make_optimizer

archs, batch, seq, pool_spec = json.loads(sys.argv[1])
mesh = jax.make_mesh((2, 4), ("data", "model"))


def specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            [e if e is None or isinstance(e, str) else list(e)
             for e in sh.spec] for path, sh in flat}


pols = {k: make_policy(mesh, shape_kind=k)
        for k in ("train", "decode", "long_decode")}
out = {}
for arch in archs:
    cfg = reduce_config(get_config(arch))
    out[f"{arch}/params"] = specs(ts.param_shardings(cfg, pols["train"]))
    for name in ("adamw", "adafactor"):
        out[f"{arch}/{name}"] = specs(ts.opt_state_shardings(
            cfg, pols["train"], make_optimizer(name)))
    for kind in ("train", "decode"):
        spec = api.input_spec_shapes(cfg, ShapeCfg("t", seq, batch, kind))
        out[f"{arch}/batch/{kind}"] = specs(ts.batch_shardings(
            cfg, pols[kind], spec))
    state = api.decode_cache_shape(cfg, batch, seq)
    for kind in ("decode", "long_decode"):
        out[f"{arch}/state/{kind}"] = specs(ts.decode_state_shardings(
            cfg, pols[kind], state))
pool = NamPool()
for name, shape, dtype, axes in pool_spec:
    pool.alloc(name, tuple(shape), jnp.dtype(dtype),
               tuple(axes) if axes else None)
out["pool"] = specs(pool.shardings(pols["train"]))
out["pool_specs"] = {n: [list(s.shape), str(s.dtype)]
                     for n, s in pool.specs().items()}
print("SHARDING_ORACLE " + json.dumps(out))
"""


class _Axes:
    """A mesh description for JAX's make_policy (it reads the names)."""

    def __init__(self, names):
        self.axis_names = names


def _spec(p):
    return [e if e is None or isinstance(e, str) else list(e) for e in p]


def _specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_specs(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: _spec(tree.spec)}


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def oracle():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    arg = json.dumps([list(ARCH_IDS), BATCH, SEQ,
                      [list(p) for p in POOL]])
    r = subprocess.run([sys.executable, "-c", _ORACLE, arg], env=env,
                       capture_output=True, text=True, timeout=600)
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("SHARDING_ORACLE ")]
    assert line, r.stderr[-3000:]
    return json.loads(line[0][len("SHARDING_ORACLE "):])


@pytest.mark.parametrize("decode_tp", [False, True])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("axes", [("data", "model"),
                                  ("pod", "data", "model")])
def test_make_policy_resolves_as_jax(monkeypatch, decode_tp, kind, axes):
    monkeypatch.setattr(policy, "DECODE_TP", decode_tp)
    monkeypatch.setattr(jpolicy, "DECODE_TP", decode_tp)
    over = {"ff": None} if kind == "prefill" else None
    want = jpolicy.make_policy(_Axes(axes), shape_kind=kind, overrides=over)
    got = policy.make_policy(_Axes(axes), shape_kind=kind, overrides=over)
    assert got.rules == want.rules
    for la in LOGICAL:
        assert tuple(got.resolve(la)) == tuple(want.resolve(la)), la
        assert got.resolve(la) == want.resolve(la)


def test_param_pspec_and_constrain():
    for la in LOGICAL:
        assert tuple(policy.param_pspec(la)) == \
            tuple(jpolicy.param_pspec(la))
        assert tuple(policy.param_pspec(la, {"embed": None})) == \
            tuple(jpolicy.param_pspec(la, {"embed": None}))
    x = torch.zeros(2, 3)
    assert policy.constrain(x, "batch") is x          # no policy: no check
    mesh = Mesh((2, 4), ("data", "model"), device="cpu")
    with policy.set_policy(policy.make_policy(mesh)):
        assert policy.current_policy().mesh is mesh
        assert policy.constrain(x, "batch", None) is x
        with pytest.raises(ValueError, match="logical axes"):
            policy.constrain(x, "batch")
    assert policy.current_policy() is None
    assert policy.P(("data",), (), ["pod", "data"]) == \
        ("data", None, ("pod", "data"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_logical_axes_equal_jax(arch):
    got = _paths(api.param_logical_axes(reduce_config(get_config(arch))))
    want = _paths(japi.param_logical_axes(jreduce(jget(arch))))
    assert got == want
    shapes = _paths(api.param_shapes(reduce_config(get_config(arch))))
    assert got.keys() == shapes.keys()
    assert all(len(got[k]) == len(shapes[k]) for k in got)


def test_init_params_keep_their_values():
    """The axes ride along; the draws are the same as without them."""
    cfg = reduce_config(get_config("deepseek-v2-236b"))
    a = api.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = api.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    flat = _paths(a)
    assert all(torch.equal(flat[k], v) for k, v in _paths(b).items())
    # the draw order is the builders' call order: the first leaf drawn is
    # the embedding, normal at 0.02
    g = torch.Generator().manual_seed(5)
    assert torch.equal(flat["embed"], torch.randn(
        tuple(flat["embed"].shape), generator=g).mul_(0.02))


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh(2, 4, device="cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_shardings_equal_jax(oracle, mesh, arch):
    cfg = reduce_config(get_config(arch))
    pols = {k: policy.make_policy(mesh, shape_kind=k)
            for k in ("train", "decode", "long_decode")}
    assert _specs(ts.param_shardings(cfg, pols["train"])) == \
        oracle[f"{arch}/params"]
    for name in ("adamw", "adafactor"):
        assert _specs(ts.opt_state_shardings(
            cfg, pols["train"], make_optimizer(name))) == \
            oracle[f"{arch}/{name}"], name
    for kind, s in (("train", SEQ), ("decode", 1)):
        spec = {"tokens": (BATCH, s)}
        if kind == "train":
            spec["labels"] = (BATCH, s)
        if cfg.modality_dim:
            spec["modality"] = (BATCH, cfg.num_modality_tokens,
                                cfg.modality_dim)
        want = oracle[f"{arch}/batch/{kind}"]
        assert _specs(ts.batch_shardings(cfg, pols[kind], {
            k: v for k, v in spec.items() if k in want})) == want
    state = api.decode_cache_shape(cfg, BATCH, SEQ)
    for kind in ("decode", "long_decode"):
        assert _specs(ts.decode_state_shardings(cfg, pols[kind], state)) \
            == oracle[f"{arch}/state/{kind}"], kind


def test_sharding_functions_allocate_nothing(mesh):
    """They read shapes: the parameters of llama4 at full width would take
    1.6 TB."""
    cfg = get_config("llama4-maverick-400b-a17b")
    pol = policy.make_policy(mesh)
    sh = ts.opt_state_shardings(cfg, pol, make_optimizer("adamw"))
    assert _specs(sh)["m/embed"] == ["model", None]
    assert _specs(ts.param_shardings(cfg, pol))["embed"] == ["model", None]


def test_nam_pool_shardings_equal_jax(oracle, mesh):
    pool = NamPool()
    for name, shape, dtype, axes in POOL:
        pool.alloc(name, shape, getattr(torch, "int32" if dtype == "uint32"
                                        else dtype), axes)
    assert _specs(pool.shardings(policy.make_policy(mesh))) == \
        oracle["pool"]
    assert {n: [list(s), str(d).replace("torch.", "")]
            for n, (s, d) in pool.specs().items()} == {
        n: [s, "int32" if d == "uint32" else d]
        for n, (s, d) in oracle["pool_specs"].items()}


def test_a_sharding_cuts_views_at_the_shards_coordinates(mesh):
    x = torch.arange(16 * 6).reshape(16, 6)
    sh = policy.NamedSharding(mesh, policy.P(("data", "model"), None))
    blocks = [sh.block(x, i) for i in range(8)]
    assert all(b.data_ptr() == x[2 * i:2 * i + 2].data_ptr()
               for i, b in enumerate(blocks))
    sh = policy.NamedSharding(mesh, policy.P(("model", "data"), None))
    assert np.array_equal([int(sh.block(x, i)[0, 0]) // 12
                           for i in range(8)], [0, 2, 4, 6, 1, 3, 5, 7])
