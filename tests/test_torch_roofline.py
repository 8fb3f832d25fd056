"""The roofline of one eager step (``launch/roofline.py``) and the card's
roofline block (``core/costmodel.py``) against the JAX package's.

The jitted JAX steps are counted once, in a subprocess (one CPU device),
by JAX's own ``HloModule(...).flops()``; everything else compares in this
process:

  * ``roofline_terms`` under a spec holding JAX's TPU numbers equals
    JAX's; ``model_flops*`` and every config's ``param_counts`` equal;
  * the counter's dots-only FLOPs of a one-device prefill step (B 2 x S 64
    of each ``reduce_config``) against ``HloModule.flops()``: glm4
    exactly (27 262 976); deepseek through ``_moe_reference`` in both
    packages, but for the router product that XLA computes once a layer
    (common-subexpression elimination merges the load-balancing loss's
    and the dispatch's) and the eager step twice; mamba2 exactly once the
    plain SSD takes the config's chunk (``ref._SSD_CHUNK`` is 64, JAX's
    ``ssd_chunked`` takes ``cfg.ssm.chunk``, 32 here), and the gap at 64
    is the C B^T and intra-chunk products of the longer chunk, op by op;
  * the counter sees every shard body of a (2, 4) mesh, each the same;
  * the collectives' ring model equals JAX's (``HloModule.
    collective_bytes`` on HLO of each kind), kind by kind, and the mesh's
    collectives record it with their own member count;
  * a kernel region is counted by its inputs and outputs once, with its
    own FLOPs, and its plain ops count only in the JAX-comparable totals;
  * peak live bytes follow storages as they are made and freed.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import costmodel as jcost
from repro.launch.roofline import HloModule
from repro_torch.configs import ARCH_IDS, ShapeCfg, get_config, reduce_config
from repro_torch.core import costmodel
from repro_torch.kernels import ops, ref
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_host_mesh, shard_map
from repro_torch.models import api, moe
from repro_torch.sharding import P, make_policy, set_policy
from repro_torch.train import train_step as ts

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("glm4-9b", "mamba2-370m", "deepseek-v2-236b")
B, S = 2, 64

_ORACLE = r"""
import sys
import jax, jax.numpy as jnp
from repro.configs import get_config, reduce_config
from repro.launch.roofline import HloModule
from repro.models import api
from repro.train import train_step as ts
for arch in sys.argv[1].split(","):
    cfg = reduce_config(get_config(arch))
    params = jax.eval_shape(lambda: api.init_params(cfg,
                                                    jax.random.PRNGKey(0)))
    batch = {"tokens": jax.ShapeDtypeStruct((2, 64), jnp.int32)}
    c = jax.jit(ts.build_prefill_step(cfg)).lower(params, batch).compile()
    print(f"FLOPS {arch} {HloModule(c.as_text()).flops()!r}")
"""


@pytest.fixture(scope="module")
def jax_flops():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _ORACLE, ",".join(ARCHS)],
                       env=env, capture_output=True, text=True, timeout=600)
    out = {}
    for line in r.stdout.splitlines():
        if line.startswith("FLOPS "):
            _, arch, v = line.split()
            out[arch] = float(v)
    assert set(out) == set(ARCHS), r.stderr[-3000:]
    return out


def _count_prefill(cfg, device="meta", policy=None) -> roofline.StepCounter:
    params = ts._meta(api.param_shapes(cfg)) if device == "meta" else \
        api.init_params(cfg, device=device)
    tokens = torch.zeros((B, S), dtype=torch.int32, device=device)
    with set_policy(policy), roofline.StepCounter() as c:
        ts.build_prefill_step(cfg)(params, {"tokens": tokens})
    return c


# ------------------------------------------------------------ costmodel --

def test_roofline_terms_equal_jax_s_under_its_spec():
    tpu = costmodel.GpuSpec(name=jcost.TPU.name,
                            peak_flops_bf16=jcost.TPU.peak_flops_bf16,
                            hbm_bw=jcost.TPU.hbm_bw,
                            link_bw=jcost.TPU.ici_link_bw,
                            hbm_bytes=jcost.TPU.hbm_bytes)
    for args in ((1e12, 3e9, 2e8), (5e14, 1e9, 0.0), (1.0, 2e12, 4e11)):
        assert costmodel.roofline_terms(*args, spec=tpu) == \
            jcost.roofline_terms(*args)
    h = costmodel.roofline_terms(989e12, 3.35e12, 450e9)
    assert h["compute_s"] == h["memory_s"] == h["collective_s"] == 1.0
    assert costmodel.H100.peak_flops_tf32 == 495e12
    assert costmodel.H100.peak_flops_f32 == 67e12


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_param_counts_equal_jax_s(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.param_counts() == jcfg.param_counts()
    rc = reduce_config(cfg)
    assert rc.param_counts() == \
        __import__("repro.configs", fromlist=["reduce_config"]) \
        .reduce_config(jcfg).param_counts()
    n, na = cfg.param_counts()
    for tokens in (1, 4096, 256 * 4096):
        assert costmodel.model_flops(na, tokens) == \
            jcost.model_flops(na, tokens)
        assert costmodel.model_flops_fwd(n, tokens) == \
            jcost.model_flops_fwd(n, tokens)


# ---------------------------------------------------------------- FLOPs --

def test_glm4_prefill_dots_equal_hlo_flops_exactly(jax_flops):
    cfg = reduce_config(get_config("glm4-9b"))
    for device in ("meta", "cpu"):
        c = _count_prefill(cfg, device)
        assert c.totals()["flops"] == jax_flops["glm4-9b"] == 27_262_976


def test_moe_prefill_dots_equal_hlo_flops_but_the_merged_router(
        jax_flops, monkeypatch):
    cfg = reduce_config(get_config("deepseek-v2-236b"))
    monkeypatch.setattr(moe, "_moe_packed", lambda cfg, mcfg, p, x, impl=None:
                        moe._moe_reference(cfg, mcfg, p, x))
    c = _count_prefill(cfg)
    T, D, E = B * S, cfg.d_model, cfg.moe.num_experts
    router = 2 * T * D * E                  # the second router product
    assert c.totals()["flops"] - jax_flops["deepseek-v2-236b"] == \
        len(cfg.moe_layer_ids()) * router


def _chunk_products(cfg, L: int) -> int:
    """The dots of the plain SSD that depend on the chunk length L: per
    chunk C B^T (2 B L^2 N) and the intra-chunk product (2 B H L^2 P)."""
    s = cfg.ssm
    H = s.expand * cfg.d_model // s.head_dim
    per_chunk = 2 * B * L * L * s.d_state + 2 * B * H * L * L * s.head_dim
    return cfg.num_layers * (S // L) * per_chunk


def test_mamba2_prefill_dots_and_the_plain_ssd_s_chunk(jax_flops,
                                                       monkeypatch):
    cfg = reduce_config(get_config("mamba2-370m"))
    at64 = _count_prefill(cfg).totals()["flops"]
    assert ref._SSD_CHUNK == 64 and cfg.ssm.chunk == 32
    assert at64 - jax_flops["mamba2-370m"] == \
        _chunk_products(cfg, 64) - _chunk_products(cfg, 32) == 2_359_296
    monkeypatch.setattr(ref, "_SSD_CHUNK", cfg.ssm.chunk)
    assert _count_prefill(cfg).totals()["flops"] == \
        jax_flops["mamba2-370m"]


# --------------------------------------------------------------- shards --

def test_the_counter_sees_every_shard_body():
    cfg = reduce_config(get_config("deepseek-v2-236b"))
    pol = make_policy(make_host_mesh(2, 4, device="cpu"))
    c = _count_prefill(cfg, "cpu", policy=pol)
    assert c.shards == list(range(8))
    per = [c.tallies[i] for i in range(8)]
    assert per[0].flops > 0 and per[0].collectives["all-to-all"] > 0
    assert all(t.flops == per[0].flops and t.bytes == per[0].bytes
               for t in per)
    n_moe = len(cfg.moe_layer_ids())
    assert all(t.regions["rank"][0] == 2 * n_moe for t in per)
    # a meta mesh runs one body for all eight: the same counts
    m = _count_prefill(cfg, policy=make_policy(make_host_mesh(
        2, 4, device="meta")))
    assert m.shards == [0] and m.stands_for == {0: 8}
    assert m.totals() == c.totals()

    def nonzero(pc):
        return dict(pc, bytes_by_op={k: v for k, v in pc["bytes_by_op"]
                                     .items() if v})
    assert nonzero(m.per_chip(8)) == nonzero(c.per_chip(8))
    # one device, no policy: no shard at all
    assert _count_prefill(reduce_config(get_config("glm4-9b"))).shards == []


# ---------------------------------------------------------- collectives --

_HLO = """HloModule m

ENTRY %main (p: f32[{shape}]) -> f32[{shape}] {{
  %p = f32[{shape}]{{1,0}} parameter(0)
  ROOT %c = f32[{shape}]{{1,0}} {kind}(%p), replica_groups=[{g},{n}]<=[{t}]
}}
"""


@pytest.mark.parametrize("kind", roofline.KINDS)
@pytest.mark.parametrize("n", [2, 4, 16])
def test_the_ring_model_is_jax_s(kind, n):
    for shape in ((32, 16), (7, 3)):
        text = _HLO.format(shape=",".join(map(str, shape)), kind=kind, g=2,
                           n=n, t=2 * n)
        b = 4 * shape[0] * shape[1]
        assert HloModule(text).collective_bytes()[kind] == \
            roofline.ring_bytes(kind, b, n)


def test_the_mesh_records_each_collective_with_its_members():
    mesh = make_host_mesh(2, 4, device="cpu")

    def body(x, w):
        a = mesh.all_gather(w, "data", dim=0)             # (2, 6)
        s = mesh.psum(x, "model")                         # (8, 4)
        t = mesh.all_to_all(x.reshape(4, 2, 4), "model", 0, 0)
        r = mesh.psum_scatter(a, "data", dim=0)           # (1, 6)
        return s + t.reshape(8, 4) + r.sum() + a.sum()

    f = shard_map(body, mesh, (P("data", "model"), P("data", None)),
                  P("data", "model"))
    with roofline.StepCounter() as c:
        f(torch.ones(16, 16), torch.ones(2, 6))
    want = {"all-gather": roofline.ring_bytes("all-gather", 4 * 2 * 6, 2),
            "all-reduce": roofline.ring_bytes("all-reduce", 4 * 8 * 4, 4),
            "all-to-all": roofline.ring_bytes("all-to-all", 4 * 8 * 4, 4),
            "reduce-scatter": roofline.ring_bytes("reduce-scatter", 4 * 6,
                                                  2)}
    for i in range(8):
        assert c.tallies[i].collectives == want
    row = roofline.analyze(reduce_config(get_config("glm4-9b")),
                           ShapeCfg("x", 16, 16, "prefill"), c, 8)
    assert row["collective_bytes_per_chip"]["total"] == sum(want.values())


# -------------------------------------------------------------- regions --

def _io(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


@pytest.mark.parametrize("causal", [True, False])
def test_a_flash_region_counts_its_inputs_and_outputs_once(causal):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 32, 4, 16, generator=g)
    k = torch.randn(2, 32, 2, 16, generator=g)
    v = torch.randn(2, 32, 2, 8, generator=g)
    with roofline.StepCounter() as c:
        out = ops.flash_attention(q, k, v, causal=causal)
    t = c.totals()
    assert t["regions"] == {"flash_attention": [
        1, roofline.attention_flops(2, 32, 32, 4, 16, 8, causal),
        _io(q, k, v, out)]}
    assert t["bytes_k"] == _io(q, k, v, out)
    assert t["flops_k"] == roofline.attention_flops(2, 32, 32, 4, 16, 8,
                                                    causal)
    # the plain version's ops count in the JAX-comparable totals only
    assert t["flops"] == 2 * 2 * 4 * 32 * 32 * (16 + 8)
    assert t["bytes"] > t["bytes_k"]


def test_rank_scatter_and_ssd_regions():
    g = torch.Generator().manual_seed(1)
    dest = torch.randint(0, 4, (64,), generator=g, dtype=torch.int32)
    rows = torch.randint(0, 9, (64, 3), generator=g, dtype=torch.int32)
    xh = torch.randn(1, 64, 2, 8, generator=g)
    bv, cv = torch.randn(1, 64, 4, generator=g), torch.randn(1, 64, 4,
                                                              generator=g)
    dt, a = torch.rand(1, 64, 2, generator=g), -torch.rand(2, generator=g)
    with roofline.StepCounter() as c:
        slot, keep, over, counts = ops.rank(dest, 4, 32)
        buf = ops.scatter_rows(rows, slot, 128, counts=counts)
        y, st = ops.ssd_scan(xh, bv, cv, dt, a)
    reg = c.totals()["regions"]
    assert reg["rank"] == [1, 0.0, _io(dest, slot, keep, over, counts)]
    assert reg["scatter"] == [1, 0.0, _io(rows, slot, counts, buf)]
    assert reg["ssd_scan"] == [1, roofline.ssd_flops(1, 64, 2, 8, 4),
                               _io(xh, bv, cv, dt, a, y, st)]
    assert c.totals()["bytes_k"] == sum(r[2] for r in reg.values())


def test_peak_live_bytes_follow_storages():
    with roofline.StepCounter() as c:
        a = torch.empty(1000, device="meta")           # 4000 B
        b = a * 2                                      # + 4000
        del a
        v = b.view(10, 100)                            # a view: nothing
        d = torch.empty(500, device="meta")            # + 2000 (a freed)
        del b, v, d
    assert c.peak_live == 8000
    assert c.live == 0


def test_analyze_keys_and_per_chip_split():
    cfg = reduce_config(get_config("glm4-9b"))
    c = _count_prefill(cfg)
    shape = ShapeCfg("x", S, B, "prefill")
    one, eight = roofline.analyze(cfg, shape, c, 1), roofline.analyze(
        cfg, shape, c, 8)
    for key in ("compute_s", "memory_s", "collective_s", "dominant",
                "bound_s", "collective_bytes_per_chip",
                "model_flops_per_chip", "useful_flop_ratio",
                "roofline_fraction", "memory_s_kernelized",
                "roofline_fraction_kernelized", "memory_breakdown",
                "step_flops_per_chip", "step_bytes_per_chip"):
        assert key in one
    assert eight["step_flops_per_chip"] * 8 == one["step_flops_per_chip"]
    assert one["model_flops_per_chip"] == costmodel.model_flops_fwd(
        cfg.param_counts()[1], B * S)
    assert one["memory_breakdown"][0][1] >= one["memory_breakdown"][-1][1]


@pytest.mark.parametrize("arch,mesh_shape", [("glm4-9b", None),
                                             ("mamba2-370m", None),
                                             ("deepseek-v2-236b", (2, 4))])
def test_the_card_s_counts_rehearsed(arch, mesh_shape):
    """``bench.serve``'s counts that phases serve and moe compare: a step
    counted on real tensors (here the CPU's, the kernels' plain versions
    inside their regions) and on meta tensors of the same shapes agree on
    everything the card can count, and a differing count names its ops."""
    from repro_torch.bench import serve
    cfg = reduce_config(get_config(arch))
    params = serve.weights(cfg, device="cpu")
    mesh = None if mesh_shape is None else make_host_mesh(*mesh_shape,
                                                          device="cpu")
    dev = serve.count_on_device(cfg, params, batch=B, seq=S, mesh=mesh)
    meta = serve.count_on_meta(cfg, batch=B, seq=S, mesh_shape=mesh_shape)
    agree, a, b = serve.counts_agree(dev, meta)
    assert agree and a == b and "by_op" not in a
    assert ("peak_live_k" in a) == (mesh is None)
    row = serve.roofline_row(meta, median_s=1.0)
    assert row["mfu"] == row["model_flops"] / costmodel.H100.peak_flops_bf16
    assert meta["n_chips"] == (1 if mesh is None else 8)
    meta["seen"]["by_op"]["None:aten.mul"] += 1.0
    meta["seen"]["bytes_k"] += 1.0
    agree, a, b = serve.counts_agree(dev, meta)
    assert not agree and set(a["by_op"]) == {"None:aten.mul"}
