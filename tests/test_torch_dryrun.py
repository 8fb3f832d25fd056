"""The dry-run (``launch/dryrun.py``) and its report (``launch/report.py``)
against the JAX package's.

The JAX side compiles each cell's jitted step once, in a subprocess with
8 forced CPU devices, on a (2, 4) mesh whose axes are
``AxisType.Auto`` (JAX 0.9's sharding constraints need them: its own
small-mesh dry-run fails without, ``test_multidevice[dryrun-...]``), and
reads ``memory_analysis().argument_size_in_bytes``:

  * the port's argument bytes per device, from shapes and the policy's
    shardings, equal JAX's for a train cell (glm4: 250 116), a prefill
    cell, a decode cell, a long-decode SSM cell and an MoE arch's train
    and decode cells;
  * every (arch x shape) cell at ``reduce_config`` and small sizes on a
    (2, 4) meta mesh gives a row, or the skip with JAX's reason;
  * the report renders the same tables as JAX's ``report.py`` for rows
    that carry the same numbers;
  * ``apply_opts`` takes JAX's toggles.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import supports_shape as jsupports_shape
from repro.launch import report as jreport
from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeCfg, get_config,
                                 reduce_config)
from repro_torch.launch import dryrun, report
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm
from repro_torch.sharding import policy as _policy

ROOT = Path(__file__).resolve().parents[1]
# arch:kind:batch:seq:shape name
CELLS = ("glm4-9b:train:8:64:train_4k", "glm4-9b:prefill:8:64:prefill_32k",
         "glm4-9b:decode:8:64:decode_32k",
         "mamba2-370m:decode:1:128:long_500k",
         "deepseek-v2-236b:train:8:64:train_4k",
         "deepseek-v2-236b:decode:8:64:decode_32k")
SMALL = {"train_4k": (64, 8), "prefill_32k": (64, 8), "decode_32k": (64, 8),
         "long_500k": (128, 1)}          # name: (seq, batch)

_ORACLE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config, reduce_config
from repro.configs.base import ShapeCfg
from repro.models import api
from repro.sharding import make_policy, set_policy
from repro.train import train_step as ts
from repro.train.optimizer import make_optimizer

for case in sys.argv[1:]:
    arch, kind, b, s, name = case.split(":")
    b, s = int(b), int(s)
    cfg = reduce_config(get_config(arch))
    shape = ShapeCfg(name, s, b, kind)
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    pk = (("long_decode" if name == "long_500k" else "decode")
          if kind == "decode" else "train")
    policy = make_policy(mesh, shape_kind=pk)
    with mesh, set_policy(policy):
        pshapes = jax.eval_shape(lambda: api.init_params(
            cfg, jax.random.PRNGKey(0)))
        if kind != "train":
            pshapes = jax.tree.map(lambda sd: jax.ShapeDtypeStruct(
                sd.shape, jnp.bfloat16) if sd.dtype == jnp.float32 else sd,
                pshapes)
        pshard = ts.param_shardings(cfg, policy)
        batch = api.input_spec_shapes(cfg, shape)
        bshard = ts.batch_shardings(cfg, policy, batch)
        if kind == "train":
            opt = make_optimizer(cfg.optimizer)
            oshapes = jax.eval_shape(opt.init, pshapes)
            oshard = ts.opt_state_shardings(cfg, policy, opt)
            lowered = jax.jit(ts.build_train_step(cfg, opt),
                              in_shardings=(pshard, oshard, bshard),
                              out_shardings=(pshard, oshard, None),
                              donate_argnums=(0, 1)).lower(pshapes, oshapes,
                                                           batch)
        elif kind == "prefill":
            lowered = jax.jit(ts.build_prefill_step(cfg),
                              in_shardings=(pshard, bshard),
                              out_shardings=None).lower(pshapes, batch)
        else:
            sshapes = api.decode_cache_shape(cfg, b, s)
            sshard = ts.decode_state_shardings(cfg, policy, sshapes)
            tok = jax.ShapeDtypeStruct((b, 1), jnp.int32)
            tshard = policy.sharding(("batch", None))
            lowered = jax.jit(ts.build_serve_step(cfg),
                              in_shardings=(pshard, sshard, tshard),
                              out_shardings=(tshard, sshard),
                              donate_argnums=(1,)).lower(pshapes, sshapes,
                                                         tok)
        mem = lowered.compile().memory_analysis()
    print("ARGS", case, mem.argument_size_in_bytes, flush=True)
"""


@pytest.fixture(scope="module")
def jax_args():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _ORACLE, *CELLS], env=env,
                       capture_output=True, text=True, timeout=600)
    out = {}
    for line in r.stdout.splitlines():
        if line.startswith("ARGS "):
            _, case, v = line.split()
            out[case] = int(v)
    assert set(out) == set(CELLS), r.stderr[-3000:]
    return out


def _cell(case):
    arch, kind, b, s, name = case.split(":")
    return (reduce_config(get_config(arch)),
            ShapeCfg(name, int(s), int(b), kind))


@pytest.mark.parametrize("case", CELLS)
def test_argument_bytes_equal_jax_s(jax_args, case):
    cfg, shape = _cell(case)
    pol = _policy.make_policy(make_host_mesh(2, 4, device="meta"),
                              shape_kind=dryrun._policy_kind(shape))
    _, _, nbytes = dryrun.cell_arguments(cfg, shape, pol)
    assert nbytes == jax_args[case]
    if case == CELLS[0]:
        assert nbytes == 250_116


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_reduced_cell_gives_a_row_or_jax_s_skip(arch):
    mesh = make_host_mesh(2, 4, device="meta")
    cfg = reduce_config(get_config(arch))
    for name, full in SHAPES.items():
        seq, batch = SMALL[name]
        shape = ShapeCfg(name, seq, batch, full.kind)
        row = dryrun.dry_cell(arch, name, mesh, cfg=cfg, shape=shape,
                              verbose=False, microbatches=2)
        ok, why = jsupports_shape(jget_config(arch), full)
        if not ok:
            assert row == {"arch": arch, "shape": name, "skipped": why}
            continue
        assert row["mesh"] == {"data": 2, "model": 4}
        assert row["memory"]["argument_bytes"] > 0
        assert row["memory"]["temp_bytes"] > 0
        r = row["roofline"]
        assert r["step_flops_per_chip"] > 0 and r["bound_s"] > 0
        assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
        if cfg.moe is not None and full.kind != "decode":
            # the RRJ's collectives, counted in its shard bodies
            assert r["collective_bytes_per_chip"]["all-to-all"] > 0


def test_the_dry_run_takes_jax_s_toggles(monkeypatch):
    monkeypatch.setattr(lm, "CE_CHUNK", 0)
    monkeypatch.setattr(_policy, "DECODE_TP", False)
    assert dryrun.apply_opts("ce_chunk=512,decode_tp,"
                             "microbatches=2") == {"microbatches": 2}
    assert lm.CE_CHUNK == 512 and _policy.DECODE_TP
    # rs_outputs asks for a partitioner the port does not have
    for opts in ("remat", "rs_outputs"):
        with pytest.raises(ValueError):
            dryrun.apply_opts(opts)
    assert dryrun.MICROBATCHES["deepseek-v2-236b"] == 4
    spec = dryrun.input_specs("llama-3.2-vision-90b", "prefill_32k")
    assert spec["modality"][0] == (32, 1601, 1280)
    assert dryrun.input_specs("glm4-9b", "decode_32k") == {
        "tokens": ((128, 1), torch.int32)}


def _rows():
    """A port row and a JAX row with the same numbers, a skip each."""
    r = {"compute_s": 0.125, "memory_s": 0.5, "collective_s": 0.25,
         "dominant": "memory_s", "bound_s": 0.5, "useful_flop_ratio": 0.75,
         "roofline_fraction": 0.2, "roofline_fraction_kernelized": 0.3,
         "collective_bytes_per_chip": {"total": 3e9},
         "param_gather_bytes_per_chip": {"total": 0.0}}
    port = {"arch": "glm4-9b", "shape": "train_4k",
            "mesh": {"data": 16, "model": 16}, "count_s": 2.5,
            "memory": {"argument_bytes": 3 * 2 ** 30,
                       "temp_bytes": 5 * 2 ** 30},
            "roofline": dict(r, step_flops_per_chip=7e12)}
    jax_row = {"arch": "glm4-9b", "shape": "train_4k", "compile_s": 2.5,
               "memory": {"argument_bytes": 3 * 2 ** 30,
                          "temp_bytes": 5 * 2 ** 30},
               "roofline": dict(r, hlo_flops_per_chip=7e12)}
    skip = {"arch": "glm4-9b", "shape": "long_500k", "skipped": "x"}
    return ([port, skip], [jax_row, skip])


def _cells(table: str) -> list:
    return [[c.strip() for c in line.strip("|").split("|")]
            for line in table.splitlines()[2:]]


def test_the_report_renders_jax_s_tables(tmp_path):
    port, jax_rows = _rows()
    for name, rows in (("port", port), ("jax", jax_rows)):
        with open(tmp_path / f"{name}.jsonl", "w") as f:
            for row in rows:
                f.write(__import__("json").dumps(row) + "\n")
    prows = report.load([tmp_path / "port.jsonl"])
    jrows = jreport.load([tmp_path / "jax.jsonl"])
    assert _cells(report.dryrun_table(prows)) == _cells(
        jreport.dryrun_table(jrows))
    got, want = (_cells(report.roofline_table(prows)),
                 _cells(jreport.roofline_table(jrows)))
    assert len(got) == len(want) == 1
    # the same columns but the port's kernelized share; the lever names
    # the port's own
    assert got[0][:8] == want[0][:8]
    assert "kernels" in got[0][-1] and "Pallas" not in got[0][-1]
    assert "Pallas" in want[0][-1]


def test_the_report_reads_the_mesh_from_the_row(tmp_path):
    port, _ = _rows()
    port[0]["mesh"] = {"data": 2, "model": 4}
    path = tmp_path / "rows.jsonl"
    path.write_text("\n".join(__import__("json").dumps(r) for r in port))
    rows = report.load([path])
    assert "| 2x4 |" in report.dryrun_table(rows)
    assert len(_cells(report.roofline_table(rows, "2x4"))) == 1
    assert _cells(report.roofline_table(rows)) == []
