"""The port's RRJ MoE dispatch and its decode twin (``models/moe.py``
under a sharding policy) against the JAX package's on a (2, 4) mesh.

The JAX side runs once, in a subprocess that sets
``--xla_force_host_platform_device_count=8`` before it imports ``jax`` (as
``tests/test_multidevice.py`` does), so this process keeps one device.
Inputs are drawn once with numpy and fed to both packages in f32.

  * ``_radix_to_buffers`` bit for bit against JAX's (buffer, every meta
    lane, valid), with drops and unsent destinations, on one device;
  * ``_moe_rrj`` and ``_moe_replicated`` at ``reduce_config(deepseek)``
    within ``TOL`` of JAX's: at ``capacity_factor`` 8.0 (JAX's own case:
    nothing drops; both also within JAX's 2e-2 of the port's
    ``_moe_reference``), and at the config's own 1.25 on routing skewed
    enough to drop, where the set of dropped assignments must be JAX's
    (each token's kept set is read back from JAX's output) and hold at
    least one, on (2, 4) and on (4, 2) (two local experts: the second
    radix pass drops too);
  * llama4's (top-1, a shared expert) and jamba's ``reduce_config``
    through ``apply_moe`` under the policy, prefill and decode;
  * ``apply_moe``'s choice of path, the errors, a gradient through the
    dispatch (the gradient of the plain RRJ's function), and the
    transport's counters left alone.
"""
import dataclasses
import itertools
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.configs import get_config, reduce_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe
from repro_torch.sharding import make_policy, set_policy

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4               # f32: rtol = atol against JAX's dispatch
REF_TOL = 2e-2           # JAX's own tolerance against the reference loop
DS = "deepseek-v2-236b"
# name: (arch, capacity_factor, mesh, input, what runs)
CASES = {
    "ds8": (DS, 8.0, (2, 4), "x_small", "dispatch"),
    "ds125": (DS, None, (2, 4), "x_skew", "dispatch"),
    "ds125_m42": (DS, None, (4, 2), "x_skew", "dispatch"),
    "llama4": ("llama4-maverick-400b-a17b", None, (2, 4), "x_small",
               "apply"),
    "jamba": ("jamba-1.5-large-398b", None, (2, 4), "x_small", "apply"),
}

_ORACLE = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduce_config
from repro.models import moe as M
from repro.sharding import make_policy, set_policy

tmp = sys.argv[1]
d = dict(np.load(os.path.join(tmp, "inputs.npz")))
cases = eval(sys.argv[2])
out = {}
for name, (arch, cf, mesh_shape, xkey, what) in cases.items():
    cfg = reduce_config(get_config(arch))
    mcfg = cfg.moe if cf is None else dataclasses.replace(cfg.moe,
                                                          capacity_factor=cf)
    p = {k[len(arch) + 1:]: jnp.asarray(v) for k, v in d.items()
         if k.startswith(arch + "/")}
    mesh = jax.make_mesh(mesh_shape, ("data", "model"))
    with mesh, set_policy(make_policy(mesh)):
        if what == "dispatch":
            x = jnp.asarray(d[xkey])
            for fn in ("_moe_rrj", "_moe_replicated"):
                out[f"{name}/{fn}"] = np.asarray(jax.jit(
                    lambda x, p, fn=fn: getattr(M, fn)(cfg, mcfg, p, x))(
                        x, p))
        else:
            for dec, xk in ((False, "x_small"), (True, "x_decode")):
                y, aux = jax.jit(lambda x, p, dec=dec: M.apply_moe(
                    cfg, mcfg, p, x, decode=dec))(jnp.asarray(d[xk]), p)
                out[f"{name}/{dec}/y"] = np.asarray(y)
                out[f"{name}/{dec}/aux"] = np.asarray(aux)
np.savez(os.path.join(tmp, "outputs.npz"), **out)
print("MOE_RRJ_ORACLE_OK")
"""


def _params(arch, rng, router_scale):
    """The MoE layer's parameters: the router at ``router_scale``, the
    experts at fan-in scale (outputs of order one, so a dropped
    assignment shows far above ``TOL``)."""
    cfg = reduce_config(get_config(arch))
    shapes = moe.build_moe(cfg, cfg.moe, lambda shape, axes, scale="fan_in":
                           shape)
    return {k: (rng.standard_normal(s) * (router_scale if k == "router"
                                           else s[-2] ** -0.5)
                ).astype(np.float32) for k, s in shapes.items()}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(26)
    D = reduce_config(get_config(DS)).d_model
    d = {"x_small": rng.standard_normal((4, 8, D)).astype(np.float32),
         "x_decode": rng.standard_normal((4, 1, D)).astype(np.float32)}
    # a common offset of every token: the router favours some experts, as
    # trained routers do, so the config's capacity factor drops
    d["x_skew"] = (rng.standard_normal((4, 64, D)) + 1.5
                   * rng.standard_normal(D)).astype(np.float32)
    for arch, scale in ((DS, 0.3), ("llama4-maverick-400b-a17b", 0.1),
                        ("jamba-1.5-large-398b", 0.1)):
        d.update({f"{arch}/{k}": v
                  for k, v in _params(arch, rng, scale).items()})
    return d


@pytest.fixture(scope="module")
def oracle(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_rrj_oracle")
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _ORACLE, str(tmp),
                        repr(CASES)], env=env, capture_output=True,
                       text=True, timeout=600)
    assert "MOE_RRJ_ORACLE_OK" in r.stdout, r.stderr[-3000:]
    return dict(np.load(tmp / "outputs.npz"))


def _case(name, inputs):
    arch, cf, mesh_shape, xkey, _ = CASES[name]
    cfg = reduce_config(get_config(arch))
    mcfg = cfg.moe if cf is None else dataclasses.replace(cfg.moe,
                                                          capacity_factor=cf)
    p = {k[len(arch) + 1:]: torch.from_numpy(v.copy())
         for k, v in inputs.items() if k.startswith(arch + "/")}
    mesh = make_host_mesh(*mesh_shape, device="cpu")
    return cfg, mcfg, p, mesh, torch.from_numpy(inputs[xkey].copy())


def _contributions(mcfg, p, x):
    """(T, k, D): each assignment's gate-weighted expert output, f32."""
    xt = x.reshape(-1, x.shape[-1])
    vals, idx, _ = moe._gates(mcfg, xt, p["router"])
    return torch.stack([torch.stack([
        vals[t, j] * moe._expert_ffn(xt[t:t + 1], p["wi"][e], p["wo"][e])[0]
        for j, e in enumerate(idx[t].tolist())]) for t in range(xt.shape[0])])


def _kept_from_output(contrib, y):
    """Each token's kept assignments (T, k) read from a dispatch's output:
    the one subset of its k contributions that sums to its row."""
    T, k, _ = contrib.shape
    masks = torch.tensor(list(itertools.product((0.0, 1.0), repeat=k)))
    sums = torch.einsum("mk,tkd->tmd", masks, contrib)          # (T, 2^k, D)
    err = (sums - y.reshape(T, 1, -1)).abs().amax(-1)
    best = err.argmin(-1)
    top2 = err.sort(-1).values[:, :2]
    assert bool((top2[:, 0] <= TOL).all()), top2[:, 0].max()
    assert bool((top2[:, 1] > 10 * TOL).all()), "drop sets not told apart"
    return masks[best] > 0


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_radix_to_buffers_is_jax_bit_for_bit(dtype):
    rng = np.random.default_rng(7)
    T, D, A, n, cap = 24, 6, 48, 4, 8
    xt = rng.standard_normal((T, D)).astype(np.float32)
    jx = jnp.asarray(xt) if dtype == np.float32 else \
        jnp.asarray(xt).astype(jnp.bfloat16)
    tx = torch.from_numpy(xt.copy())
    tx = tx if dtype == np.float32 else tx.to(torch.bfloat16)
    # destinations skewed to 0 (drops) and some == n (not sent)
    dest = np.minimum(rng.integers(0, n + 2, A), n).astype(np.int32)
    dest[:20] = 0
    src = rng.integers(0, T, A).astype(np.int32)
    meta = {"gate": rng.random(A).astype(np.float32),
            "local_e": rng.integers(0, 5, A).astype(np.int32),
            "src": src}
    jbuf, jmeta, jvalid = jmoe._radix_to_buffers(
        jx, jnp.asarray(dest), jnp.asarray(src),
        {k: jnp.asarray(v) for k, v in meta.items()}, n, cap)
    buf, tmeta, valid, plan = moe._radix_to_buffers(
        tx, torch.from_numpy(dest), torch.from_numpy(src),
        {k: torch.from_numpy(v.copy()) for k, v in meta.items()}, n, cap)
    assert int(plan.dropped) > 0
    assert np.array_equal(np.asarray(jbuf.astype(jnp.float32)),
                          buf.float().numpy())
    assert buf.dtype == tx.dtype
    for k in meta:
        assert np.array_equal(np.asarray(jmeta[k]), tmeta[k].numpy()), k
    assert np.asarray(jvalid).dtype == valid.numpy().dtype == np.float32
    assert np.array_equal(np.asarray(jvalid), valid.numpy())


def test_dispatch_without_drops_matches_jax_and_the_reference(inputs,
                                                              oracle):
    cfg, mcfg, p, mesh, x = _case("ds8", inputs)
    with set_policy(make_policy(mesh)):
        rrj, kept = moe._moe_rrj(cfg, mcfg, p, x, kept=True)
        rep, kept_rep = moe._moe_replicated(cfg, mcfg, p, x, kept=True)
    assert bool(kept.all()) and bool(kept_rep.all())
    ref = moe._moe_reference(cfg, mcfg, p, x)
    for got, fn in ((rrj, "_moe_rrj"), (rep, "_moe_replicated")):
        np.testing.assert_allclose(got.numpy(), oracle[f"ds8/{fn}"],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=REF_TOL,
                                   atol=REF_TOL)


@pytest.mark.parametrize("name", ["ds125", "ds125_m42"])
def test_dropped_assignments_are_jax_s(inputs, oracle, name):
    cfg, mcfg, p, mesh, x = _case(name, inputs)
    assert mcfg.capacity_factor == 1.25
    with set_policy(make_policy(mesh)):
        rrj, kept = moe._moe_rrj(cfg, mcfg, p, x, kept=True)
        rep, kept_rep = moe._moe_replicated(cfg, mcfg, p, x, kept=True)
    dropped = int((~kept).sum())
    assert 0 < dropped < kept.numel() // 4, dropped
    np.testing.assert_allclose(rrj.numpy(), oracle[f"{name}/_moe_rrj"],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(rep.numpy(),
                               oracle[f"{name}/_moe_replicated"],
                               rtol=TOL, atol=TOL)
    contrib = _contributions(mcfg, p, x)
    T, k = contrib.shape[:2]
    jax_kept = _kept_from_output(contrib, torch.from_numpy(
        oracle[f"{name}/_moe_rrj"]))
    assert torch.equal(jax_kept, kept.reshape(T, k))
    assert torch.equal(_kept_from_output(contrib, rrj), kept.reshape(T, k))
    assert torch.equal(kept_rep.reshape(T, k), _kept_from_output(
        contrib, torch.from_numpy(oracle[f"{name}/_moe_replicated"])))


@pytest.mark.parametrize("name", ["llama4", "jamba"])
@pytest.mark.parametrize("decode", [False, True])
def test_apply_moe_under_the_policy_matches_jax(inputs, oracle, name,
                                                decode):
    cfg, mcfg, p, mesh, _ = _case(name, inputs)
    x = torch.from_numpy(inputs["x_decode" if decode else "x_small"].copy())
    with set_policy(make_policy(mesh)):
        y, aux = moe.apply_moe(cfg, mcfg, p, x, decode=decode)
    np.testing.assert_allclose(y.numpy(), oracle[f"{name}/{decode}/y"],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(aux.numpy(), oracle[f"{name}/{decode}/aux"],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mesh_shape,experts,decode,path", [
    (None, 4, False, "_moe_packed"),
    (None, 4, True, "_moe_reference"),
    ((8, 1), 4, False, "_moe_packed"),
    ((8, 1), 4, True, "_moe_reference"),
    ((1, 8), 4, False, "_moe_packed"),        # 8 does not divide 4 experts
    ((1, 8), 4, True, "_moe_reference"),
    ((2, 4), 4, False, "_moe_rrj"),
    ((2, 4), 4, True, "_moe_replicated"),
    ((2, 4), 8, False, "_moe_rrj"),
])
def test_apply_moe_picks_its_path(monkeypatch, mesh_shape, experts, decode,
                                  path):
    cfg = reduce_config(get_config(DS))
    mcfg = dataclasses.replace(cfg.moe, num_experts=experts, num_shared=0)
    called = []
    for fn in ("_moe_packed", "_moe_reference", "_moe_rrj",
               "_moe_replicated"):
        monkeypatch.setattr(moe, fn, lambda *a, fn=fn, **kw: called.append(
            fn) or torch.zeros_like(a[3]))
    p = {"router": torch.zeros(cfg.d_model, experts),
         "wi": torch.zeros(experts, cfg.d_model, 2),
         "wo": torch.zeros(experts, 1, cfg.d_model)}
    x = torch.zeros(8, 8, cfg.d_model)
    pol = (None if mesh_shape is None
           else make_policy(make_host_mesh(*mesh_shape, device="cpu")))
    with set_policy(pol):
        moe.apply_moe(cfg, mcfg, p, x, decode=decode)
        if mesh_shape == (2, 4) and not decode:      # one position: decode
            moe.apply_moe(cfg, mcfg, p, x[:, :1])
            assert called[-1] == "_moe_replicated"
            called.pop()
    assert called == [path]


def test_the_dispatch_refuses_what_it_cannot_run(inputs):
    cfg, mcfg, p, mesh, x = _case("ds125", inputs)
    with set_policy(make_policy(mesh)):
        with pytest.raises(ValueError, match=r"\(4, 6, 64\).*model"):
            moe._moe_rrj(cfg, mcfg, p, x[:, :6])        # S % 4
        with pytest.raises(ValueError, match=r"\(3, 8, 64\).*data"):
            moe._moe_replicated(cfg, mcfg, p, x[:3, :8])  # B % 2
        # a gradient is wanted: it flows, and it is the gradient of the
        # plain RRJ's function (the reference loop with the dropped
        # assignments' gates zeroed)
        wi = p["wi"].clone().requires_grad_()
        xg = x.clone().requires_grad_()
        y, _ = moe.apply_moe(cfg, mcfg, dict(p, wi=wi), xg)
        with torch.no_grad():
            _, kept = moe._moe_rrj(cfg, mcfg, p, x, kept=True)
    assert int((~kept).sum()) > 0
    g = torch.ones_like(y)
    got = torch.autograd.grad(y, [xg, wi], g)
    xr, wr = x.clone().requires_grad_(), p["wi"].clone().requires_grad_()
    xt = xr.reshape(-1, xr.shape[-1])
    vals, idx, _ = moe._gates(mcfg, xt, p["router"])
    vals = torch.where(kept.reshape(vals.shape), vals, 0.0)
    ref = torch.zeros_like(xt)
    for e in range(mcfg.num_experts):
        w = torch.where(idx == e, vals, 0.0).sum(-1)
        ref = ref + moe._expert_ffn(xt, wr[e], p["wo"][e]) * w[:, None]
    if mcfg.num_shared:
        gs, us = torch.einsum("bsd,df->bsf", xr, p["shared_wi"]).chunk(2, -1)
        ref = ref + torch.einsum("bsf,fd->bsd", torch.nn.functional.silu(gs)
                                 * us, p["shared_wo"]).reshape(ref.shape)
    want = torch.autograd.grad(ref.reshape(x.shape), [xr, wr], g)
    for a, b in zip(got, want):
        assert bool(a.abs().sum() > 0)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


def test_a_dispatch_adds_nothing_to_the_transport_counters(inputs):
    cfg, mcfg, p, mesh, x = _case("ds125", inputs)
    before = mesh.transport.stats()
    with set_policy(make_policy(mesh)):
        moe._moe_rrj(cfg, mcfg, p, x)
        moe._moe_replicated(cfg, mcfg, p, x)
    assert mesh.transport.stats() == before
    assert mesh.transport.plan_builds == 0
