"""The RRJ MoE dispatch's backward (``models/moe.py``, ``_RRJFn``) against
``jax.grad`` of the JAX package's ``_moe_rrj``, and a reduced deepseek
training step under a (2, 4) policy against JAX's.

The JAX side runs once, in a subprocess that sets
``--xla_force_host_platform_device_count=8`` before it imports ``jax``, so
this process keeps one device.  Inputs are drawn once with numpy and fed
to both packages in f32:

  * the gradients of ``_moe_rrj`` with respect to x, the router, wi and
    wo, on a (2, 4) and a (4, 2) mesh, at ``capacity_factor`` 8 (nothing
    drops) and at the config's 1.25 on routing skewed enough to drop,
    within ``TOL`` of JAX's (the forward's tolerance);
  * ``build_grad_step`` of ``reduce_config(deepseek)`` (f32 activations,
    no clipping) under a (2, 4) policy: the loss and every gradient leaf
    within ``TOL`` of JAX's grad step under the same policy (JAX's mesh
    on ``AxisType.Auto`` axes, which its sharding constraints need);
  * the backward runs no rank and the scatter twice a shard, and a
    dropped assignment passes no gradient (the masked reference loop's
    gradients).
"""
import dataclasses
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm, moe
from repro_torch.sharding import make_policy, set_policy
from repro_torch.train import train_step as ts

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4               # f32: rtol = atol against JAX's gradients
DS = "deepseek-v2-236b"
# name: (capacity_factor, mesh, input)
CASES = {"m24_cf8": (8.0, (2, 4), "x_small"),
         "m42_cf8": (8.0, (4, 2), "x_small"),
         "m24_cf125": (None, (2, 4), "x_skew"),
         "m42_cf125": (None, (4, 2), "x_skew")}
TRAIN = (4, 16)          # batch, seq of the grad step (S over 'model')

_ORACLE = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config, reduce_config
from repro.models import api, lm, moe as M
from repro.sharding import make_policy, set_policy
from repro.train import train_step as ts

tmp = sys.argv[1]
d = dict(np.load(os.path.join(tmp, "inputs.npz")))
cases = eval(sys.argv[2])
cfg = reduce_config(get_config("deepseek-v2-236b"))
p = {k[4:]: jnp.asarray(v) for k, v in d.items() if k.startswith("moe/")}
out = {}
for name, (cf, mesh_shape, xkey) in cases.items():
    mcfg = cfg.moe if cf is None else dataclasses.replace(cfg.moe,
                                                          capacity_factor=cf)
    mesh = jax.make_mesh(mesh_shape, ("data", "model"))
    x, g = jnp.asarray(d[xkey]), jnp.asarray(d["g/" + xkey])
    with mesh, set_policy(make_policy(mesh)):
        f = lambda x, p: jnp.sum(M._moe_rrj(cfg, mcfg, p, x) * g)
        gx, gp = jax.jit(jax.grad(f, argnums=(0, 1)))(x, p)
    out[f"{name}/x"] = np.asarray(gx)
    for k, v in gp.items():
        out[f"{name}/{k}"] = np.asarray(v)

lm.ACT_DTYPE = jnp.float32
params = api.init_params(cfg, jax.random.PRNGKey(0))
flat = jax.tree_util.tree_flatten_with_path(params)[0]
for path, leaf in flat:
    out["params/" + "/".join(k.key for k in path)] = np.asarray(leaf)
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
batch = {"tokens": jnp.asarray(d["tokens"]), "labels": jnp.asarray(d["labels"])}
with mesh, set_policy(make_policy(mesh)):
    step = ts.build_grad_step(cfg, max_grad_norm=float("inf"))
    grads, metrics = jax.jit(step)(params, batch)
out["train/loss"] = np.asarray(metrics["loss"])
for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
    out["grads/" + "/".join(k.key for k in path)] = np.asarray(leaf)
np.savez(os.path.join(tmp, "outputs.npz"), **out)
print("MOE_RRJ_GRAD_ORACLE_OK")
"""


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(27)
    cfg = reduce_config(get_config(DS))
    D = cfg.d_model
    shapes = moe.build_moe(cfg, cfg.moe, lambda shape, axes, scale="fan_in":
                           shape)
    d = {f"moe/{k}": (rng.standard_normal(s) * (0.3 if k == "router"
                                                 else s[-2] ** -0.5)
                      ).astype(np.float32) for k, s in shapes.items()}
    d["x_small"] = rng.standard_normal((4, 8, D)).astype(np.float32)
    # a common offset of every token: some experts are favoured and the
    # config's capacity factor drops
    d["x_skew"] = (rng.standard_normal((4, 64, D)) + 1.5
                   * rng.standard_normal(D)).astype(np.float32)
    for k in ("x_small", "x_skew"):
        d["g/" + k] = rng.standard_normal(d[k].shape).astype(np.float32)
    d["tokens"] = rng.integers(0, cfg.vocab_size, TRAIN).astype(np.int32)
    d["labels"] = rng.integers(0, cfg.vocab_size, TRAIN).astype(np.int32)
    return d


@pytest.fixture(scope="module")
def oracle(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_rrj_grad_oracle")
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _ORACLE, str(tmp),
                        repr(CASES)], env=env, capture_output=True,
                       text=True, timeout=600)
    assert "MOE_RRJ_GRAD_ORACLE_OK" in r.stdout, r.stderr[-3000:]
    return dict(np.load(tmp / "outputs.npz"))


def _case(name, inputs):
    cf, mesh_shape, xkey = CASES[name]
    cfg = reduce_config(get_config(DS))
    mcfg = cfg.moe if cf is None else dataclasses.replace(cfg.moe,
                                                          capacity_factor=cf)
    p = {k[4:]: torch.from_numpy(v.copy()).requires_grad_(True)
         for k, v in inputs.items() if k.startswith("moe/")}
    x = torch.from_numpy(inputs[xkey].copy()).requires_grad_(True)
    g = torch.from_numpy(inputs["g/" + xkey].copy())
    return cfg, mcfg, p, x, g, make_host_mesh(*mesh_shape, device="cpu")


def _grads(cfg, mcfg, p, x, g, mesh):
    with set_policy(make_policy(mesh)):
        y = moe._moe_rrj(cfg, mcfg, p, x)
        with torch.no_grad():
            _, kept = moe._moe_rrj(cfg, mcfg, p, x, kept=True)
    leaves = [x, p["router"], p["wi"], p["wo"]]
    return dict(zip(("x", "router", "wi", "wo"),
                    torch.autograd.grad(y, leaves, g))), kept


@pytest.mark.parametrize("name", list(CASES))
def test_rrj_gradients_match_jax(inputs, oracle, name):
    cfg, mcfg, p, x, g, mesh = _case(name, inputs)
    grads, kept = _grads(cfg, mcfg, p, x, g, mesh)
    dropped = int((~kept).sum())
    if CASES[name][0] is None:
        assert 0 < dropped < kept.numel() // 4, dropped
    else:
        assert dropped == 0
    for k, got in grads.items():
        want = oracle[f"{name}/{k}"]
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg=k)


def masked_reference(mcfg, p, x, kept):
    """The reference loop with each dropped assignment's gate zeroed after
    the top-k renormalization: the function the RRJ computes, in plain
    differentiable torch."""
    D = x.shape[-1]
    xt = x.reshape(-1, D)
    vals, idx, _ = moe._gates(mcfg, xt, p["router"])
    vals = torch.where(kept.reshape(vals.shape), vals, 0.0)
    out = torch.zeros_like(xt)
    for e in range(mcfg.num_experts):
        w = torch.where(idx == e, vals, 0.0).sum(-1)
        out = out + moe._expert_ffn(xt, p["wi"][e], p["wo"][e]) * w[:, None]
    return out.reshape(x.shape)


@pytest.mark.parametrize("name", ["m24_cf125", "m42_cf125"])
def test_dropped_assignments_pass_no_gradient(inputs, name):
    """A dropped assignment adds nothing to x's or its expert's gradient
    and its gate gets none: the RRJ's gradients are the masked reference
    loop's."""
    cfg, mcfg, p, x, g, mesh = _case(name, inputs)
    grads, kept = _grads(cfg, mcfg, p, x, g, mesh)
    assert int((~kept).sum()) > 0
    ref = torch.autograd.grad(masked_reference(mcfg, p, x, kept),
                              [x, p["router"], p["wi"], p["wo"]], g)
    for (k, got), want in zip(grads.items(), ref):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                                   atol=TOL, err_msg=k)


def test_the_scatter_runs_twice_an_moe_layer_a_shard_in_the_backward(
        inputs, monkeypatch):
    """Counted through the plain dispatch: the rank runs in the forward
    only (two passes a shard), the scatter twice a shard in each
    direction."""
    cfg, mcfg, p, x, g, mesh = _case("m24_cf8", inputs)
    calls = {"rank": 0, "scatter": 0}
    rank, scatter = ops.rank, ops.scatter_rows

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(ops, "rank", count("rank", rank))
    monkeypatch.setattr(ops, "scatter_rows", count("scatter", scatter))
    with set_policy(make_policy(mesh)):
        y = moe._moe_rrj(cfg, mcfg, p, x)
    fwd = dict(calls)
    torch.autograd.grad(y, [x, p["wi"]], g)
    assert fwd == {"rank": 2 * mesh.size, "scatter": 2 * mesh.size}
    assert calls == {"rank": 2 * mesh.size, "scatter": 4 * mesh.size}


@pytest.mark.parametrize("dispatch", ["rrj_kept", "replicated"])
def test_a_dispatch_without_a_backward_refuses_a_gradient(inputs, dispatch):
    """The decode twin has no backward, and the RRJ's returns no kept
    mask: when a gradient is wanted both raise rather than differentiate
    through the packed int32 lanes; without one they run."""
    cfg, mcfg, p, x, g, mesh = _case("m24_cf8", inputs)
    if dispatch == "rrj_kept":
        run = partial(moe._moe_rrj, kept=True)
        msg = "no kept mask"
    else:
        run = moe._moe_replicated
        msg = "decode MoE dispatch has no backward"
    with set_policy(make_policy(mesh)):
        with pytest.raises(NotImplementedError, match=msg):
            run(cfg, mcfg, p, x)
        with torch.no_grad():
            y, kept = run(cfg, mcfg, p, x, kept=True)
    assert y.shape == x.shape and kept.shape == x.shape[:2] + (mcfg.top_k,)


def _tree(flat: dict, prefix: str) -> dict:
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = out
        parts = key[len(prefix):].split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = torch.from_numpy(np.array(v))
    return out


def test_a_sharded_deepseek_grad_step_matches_jax(inputs, oracle,
                                                  monkeypatch):
    cfg = reduce_config(get_config(DS))
    monkeypatch.setattr(lm, "ACT_DTYPE", torch.float32)
    params = _tree(oracle, "params/")
    batch = {k: torch.from_numpy(inputs[k].astype(np.int64))
             for k in ("tokens", "labels")}
    with set_policy(make_policy(make_host_mesh(2, 4, device="cpu"))):
        grads, metrics = ts.build_grad_step(
            cfg, max_grad_norm=float("inf"))(params, batch)
    np.testing.assert_allclose(metrics["loss"].numpy(),
                               oracle["train/loss"], rtol=TOL, atol=TOL)
    want = _tree(oracle, "grads/")

    def walk(a, b, path=""):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
            return
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=path)
    walk(grads, want)


def test_the_card_s_gradient_check_rehearsed(inputs):
    """``bench.serve.rrj_grad_check``, which phase moe runs at deepseek's
    width: on CPU tensors both paths are the plain twins (equal to the
    bit), the packed experts agree at the clean tokens within f32
    rounding, and the dropped-expert control reads far above."""
    from repro_torch.bench import serve
    cfg, mcfg, p, x, g, mesh = _case("m24_cf125", inputs)
    cfg = dataclasses.replace(cfg, moe=mcfg)
    with set_policy(make_policy(mesh)):
        chk = serve.rrj_grad_check(cfg, p, x.detach(), g, tol=TOL)
    assert 0 < chk["dropped"] and chk["clean_tokens"] < chk["tokens"]
    assert all(chk["kernel_equals_plain"].values())
    assert max(chk["vs_packed"].values()) <= TOL, chk["vs_packed"]
    assert chk["control"]["wi"] > 100 * TOL
    assert max(chk["control"].values()) > 100 * TOL
    assert chk["backward_launches"] == {}          # CPU: no kernel
