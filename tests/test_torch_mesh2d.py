"""The port's two-axis mesh and ``shard_map`` (``launch/mesh.py``) against
JAX's ``shard_map`` on 8 CPU devices as a (data=2, model=4) mesh.

The JAX side runs once, in a subprocess that sets
``--xla_force_host_platform_device_count=8`` before it imports ``jax``, so
this process keeps one device.  The data are integers, so every
comparison is exact: ``axis_index`` on both axes, ``all_gather`` over
``data`` on dims 1 and 2 (tiled and stacked), ``psum`` over ``model``
and over both axes, ``all_to_all`` over ``model`` (untiled, as the MoE
dispatch calls it, and tiled), and out_specs that join two axes in
either order.  Then what the emulation itself must do: shard i at the
row-major coordinates of i, blocks as views, an indivisible shape
refused before any shard runs, the caller's grad mode in every shard,
and a production mesh that asks for nothing until it runs.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh, shard_map)
from repro_torch.sharding import NamedSharding, P

ROOT = Path(__file__).resolve().parents[1]

_ORACLE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map

tmp = sys.argv[1]
d = dict(np.load(os.path.join(tmp, "inputs.npz")))
mesh = jax.make_mesh((2, 4), ("data", "model"))
lax = jax.lax


def sm(body, ins, outs, *args):
    f = shard_map(body, mesh=mesh, in_specs=ins, out_specs=outs,
                  check_rep=False)
    return np.asarray(jax.jit(f)(*(jnp.asarray(a) for a in args)))


out = {}
x = d["x"]                                             # (4, 8, 6)
out["axis_index"] = sm(
    lambda x: (lax.axis_index("data") * 10
               + lax.axis_index("model")).reshape(1, 1) + 0 * x[:1, :1, 0],
    (P("data", "model", None),), P("data", "model"), x)
out["gather_dim1"] = sm(lambda x: lax.all_gather(x, "data", axis=1,
                                                 tiled=True),
                        (P("model", "data", None),), P("model", None, None),
                        x)
out["gather_dim2"] = sm(lambda x: lax.all_gather(x, "data", axis=2,
                                                 tiled=True),
                        (P(None, "model", "data"),), P(None, "model", None),
                        x)
out["gather_stacked"] = sm(lambda x: lax.all_gather(x, "data", axis=1,
                                                    tiled=False),
                           (P("model", "data", None),),
                           P("model", None, None, None), x)
out["psum_model"] = sm(lambda x: lax.psum(x, "model"),
                       (P("data", "model", None),), P("data", None, None), x)
out["psum_both"] = sm(lambda x: lax.psum(x, ("data", "model")),
                      (P("data", "model", None),), P(None, None, None), x)
y = d["y"]                                             # (2, 32, 3)
out["a2a"] = sm(lambda v: lax.all_to_all(
    v.reshape(4, 2, 3), "model", 0, 0, tiled=False).reshape(1, 8, 3),
    (P("data", "model", None),), P("data", "model", None), y)
out["a2a_tiled"] = sm(lambda v: lax.all_to_all(v, "model", 1, 0,
                                                tiled=True),
                      (P("data", "model", None),), P("data", "model", None),
                      y)
z = d["z"]                                             # (16, 5)
out["join_dm"] = sm(lambda v: v + 100 * lax.axis_index("data")
                    + 1000 * lax.axis_index("model"),
                    (P(("data", "model"), None),), P(("data", "model"), None),
                    z)
out["join_md"] = sm(lambda v: v + 100 * lax.axis_index("data")
                    + 1000 * lax.axis_index("model"),
                    (P(("model", "data"), None),), P(("model", "data"), None),
                    z)
out["join_two_dims"] = sm(lambda v: v * 2,
                          (P("model", "data"),), P("model", "data"),
                          d["w"])
np.savez(os.path.join(tmp, "outputs.npz"), **out)
print("MESH2D_ORACLE_OK")
"""


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    return {"x": rng.integers(-1000, 1000, (4, 8, 6)).astype(np.int32),
            "y": rng.integers(-1000, 1000, (2, 32, 3)).astype(np.int32),
            "z": rng.integers(-1000, 1000, (16, 5)).astype(np.int32),
            "w": rng.integers(-1000, 1000, (8, 6)).astype(np.int32)}


@pytest.fixture(scope="module")
def oracle(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh2d_oracle")
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _ORACLE, str(tmp)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert "MESH2D_ORACLE_OK" in r.stdout, r.stderr[-3000:]
    return dict(np.load(tmp / "outputs.npz"))


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh(2, 4, device="cpu")


def _sm(mesh, body, ins, outs, *args):
    return shard_map(body, mesh, ins, outs)(
        *(torch.from_numpy(a.copy()) for a in args)).numpy()


@pytest.fixture(scope="module")
def port(mesh, inputs):
    x, y, z = inputs["x"], inputs["y"], inputs["z"]
    out = {}
    out["axis_index"] = _sm(mesh, lambda x: torch.full(
        (1, 1), mesh.axis_index("data") * 10 + mesh.axis_index("model"),
        dtype=x.dtype), (P("data", "model", None),), P("data", "model"), x)
    out["gather_dim1"] = _sm(mesh, lambda x: mesh.all_gather(x, "data", 1),
                             (P("model", "data", None),),
                             P("model", None, None), x)
    out["gather_dim2"] = _sm(mesh, lambda x: mesh.all_gather(x, "data", 2),
                             (P(None, "model", "data"),),
                             P(None, "model", None), x)
    out["gather_stacked"] = _sm(
        mesh, lambda x: mesh.all_gather(x, "data", 1, tiled=False),
        (P("model", "data", None),), P("model", None, None, None), x)
    out["psum_model"] = _sm(mesh, lambda x: mesh.psum(x, "model"),
                            (P("data", "model", None),),
                            P("data", None, None), x)
    out["psum_both"] = _sm(mesh, lambda x: mesh.psum(x, ("data", "model")),
                           (P("data", "model", None),), P(None, None, None),
                           x)
    out["a2a"] = _sm(mesh, lambda v: mesh.all_to_all(
        v.reshape(4, 2, 3), "model", 0, 0).reshape(1, 8, 3),
        (P("data", "model", None),), P("data", "model", None), y)
    out["a2a_tiled"] = _sm(mesh, lambda v: mesh.all_to_all(
        v, "model", 1, 0, tiled=True), (P("data", "model", None),),
        P("data", "model", None), y)

    def tag(v):
        return (v + 100 * mesh.axis_index("data")
                + 1000 * mesh.axis_index("model"))
    out["join_dm"] = _sm(mesh, tag, (P(("data", "model"), None),),
                         P(("data", "model"), None), z)
    out["join_md"] = _sm(mesh, tag, (P(("model", "data"), None),),
                         P(("model", "data"), None), z)
    out["join_two_dims"] = _sm(mesh, lambda v: v * 2, (P("model", "data"),),
                               P("model", "data"), inputs["w"])
    return out


@pytest.mark.parametrize("name", [
    "axis_index", "gather_dim1", "gather_dim2", "gather_stacked",
    "psum_model", "psum_both", "a2a", "a2a_tiled", "join_dm", "join_md",
    "join_two_dims"])
def test_collectives_equal_jax(oracle, port, name):
    got = port[name]
    assert got.shape == oracle[name].shape
    assert np.array_equal(got, oracle[name])


def test_shards_sit_at_row_major_coordinates(mesh):
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 2, "model": 4} and mesh.size == 8
    assert [mesh.coords(i) for i in range(8)] == [
        (d, m) for d in range(2) for m in range(4)]
    assert all(mesh.index(mesh.coords(i)) == i for i in range(8))
    pod = make_production_mesh(multi_pod=True)
    assert pod.coords(17) == (0, 1, 1) and pod.index((1, 0, 0)) == 256


def test_blocks_are_views(mesh):
    x = torch.arange(4 * 8 * 6).reshape(4, 8, 6)
    sh = NamedSharding(mesh, P("model", "data", None))
    assert sh.shard_shape(x.shape) == (1, 4, 6)
    b = sh.block(x, 6)                           # data 1, model 2
    assert b.data_ptr() == x[2:3, 4:8].data_ptr()
    assert torch.equal(b, x[2:3, 4:8])
    seen = []
    shard_map(lambda v: seen.append(v.data_ptr()) or v, mesh,
              (P("data", "model", None),), P("data", "model", None))(x)
    assert sorted(seen) == sorted(x[d * 2:(d + 1) * 2, m * 2:(m + 1) * 2]
                                  .data_ptr() for d in range(2)
                                  for m in range(4))


def test_an_indivisible_shape_is_refused_before_any_shard_runs(mesh):
    ran = []
    f = shard_map(lambda v: ran.append(1) or v, mesh,
                  (P("data", "model"),), P("data", "model"))
    with pytest.raises(ValueError, match=r"dimension 1 of shape \(4, 6\)"):
        f(torch.zeros(4, 6))
    with pytest.raises(ValueError, match="dimension 0"):
        f(torch.zeros(3, 8))
    assert ran == []
    assert f(torch.zeros(4, 8)).shape == (4, 8)


def test_every_shard_runs_in_the_callers_grad_mode(mesh):
    modes = []

    def body(v):
        modes.append((torch.is_grad_enabled(),
                      torch.is_inference_mode_enabled()))
        return v
    f = shard_map(body, mesh, (P("data"),), P("data"))
    with torch.inference_mode():
        f(torch.zeros(2))
    with torch.no_grad():
        f(torch.zeros(2))
    f(torch.zeros(2))
    assert modes == [(False, True)] * 8 + [(False, False)] * 8 + \
        [(True, False)] * 8


def test_a_mesh_asks_for_no_device_until_something_runs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = make_production_mesh()
    assert mesh.shape == {"data": 16, "model": 16}
    assert mesh._transport is None
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.device
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh(2, 4)
    assert Mesh((2, 2), ("data", "model"), device="cpu").device == \
        torch.device("cpu")
