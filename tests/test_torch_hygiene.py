"""The port stands alone and runs on the card unless asked otherwise.

  * no module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
    ``jax``, anything of the JAX package ``repro`` or its ``benchmarks``;
  * with no card present, every entry point that was not given
    ``device=`` (the database, the transport, a host mesh, the store, the
    model's parameters, the serving engine and its launcher, the parameter
    server, the trainer and its launcher, the benchmark harness and the
    example twins) raises instead of running on the CPU;
  * a kernel wrapper given a CPU tensor raises before it builds anything;
  * every device-kernel name a wrapper lists (``KERNELS``, which the
    profiling code reads) is a ``__global__`` function of the sources;
  * the dry-run of a cell makes no tensor of a parameter's size off the
    meta device and calls no kernel;
  * the kernels import nothing of the layers above them.
"""
import ast
import math
import re
from pathlib import Path

import pytest
import torch

from repro_torch import fabric
from repro_torch._bits import resolve_device
from repro_torch.analytics import ParameterServer
from repro_torch.core import rsi
from repro_torch.configs import get_config, reduce_config
from repro_torch.bench import run as bench_run
from repro_torch.db import Database
from repro_torch.examples import nam_oltp, quickstart, serve_lm, train_lm
from repro_torch.kernels import (cas_lock, flash_attention, grouped_agg, ops,
                                 radix_partition, ssd_scan)
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch import train as launch_train
from repro_torch.models import api
from repro_torch.serving import ServeEngine
from repro_torch.train.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


KERNEL_FILES = [p for p in PORT_FILES if p.parent.name == "kernels"]


@pytest.mark.parametrize("path", KERNEL_FILES,
                         ids=[p.name for p in KERNEL_FILES])
def test_the_kernels_import_nothing_above_them(path):
    """``kernels/`` is the port's lowest layer: a step counter reaches its
    wrappers through the hook of ``kernels/_region.py``, not by import."""
    above = [m for m in _imported_modules(path)
             if m.startswith("repro_torch.") and m.split(".")[1]
             not in ("kernels", "_bits")]
    assert not above, f"{path.name} imports {above}"


def test_port_files_found():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in PORT_FILES if p.name != "chip_smoke.py"}
    assert {"core/rsi.py", "fabric/router.py", "kernels/ops.py",
            "core/workqueue.py", "train/grad_compress.py",
            "analytics/paramserver.py", "analytics/__init__.py",
            "bench/fig9_ml.py", "train/optimizer.py", "train/trainer.py",
            "data/pipeline.py", "checkpoint/manager.py", "launch/train.py",
            "bench/train.py", "tree.py", "fabric/sim.py", "fabric/check.py",
            "bench/workloads.py", "bench/fig10_contention.py",
            "bench/fig_scale.py", "fabric/tier.py", "serving/paging.py",
            "bench/fig_serve.py", "models/moe.py", "models/encdec.py",
            "sharding/__init__.py", "sharding/policy.py",
            "launch/mesh.py", "launch/roofline.py", "launch/dryrun.py",
            "launch/report.py", "bench/run.py", "bench/timing.py",
            "bench/fig7_costmodel.py", "bench/fig2_microbench.py",
            "tools/fabriccheck.py", "examples/quickstart.py",
            "examples/nam_oltp.py", "examples/serve_lm.py",
            "examples/train_lm.py"} <= names
    assert ROOT / "chip_smoke.py" in PORT_FILES
    assert len(list((ROOT / "src" / "repro_torch" / "kernels" / "csrc")
                    .glob("*.cu"))) == 5


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        Database()
    with pytest.raises(RuntimeError, match="CUDA"):
        fabric.LocalTransport()
    with pytest.raises(RuntimeError, match="CUDA"):
        fabric.MeshTransport(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh(2, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        rsi.init_store(rsi.StoreCfg(num_records=4))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    cfg = reduce_config(get_config("glm4-9b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_params(cfg)
    params = api.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", "glm4-9b", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        ParameterServer({"w": torch.zeros(4)})
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, TrainerConfig(steps=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "glm4-9b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_run.main(["--only", "fig7"])
    for example in (quickstart, nam_oltp, serve_lm, train_lm):
        with pytest.raises(RuntimeError, match="CUDA"):
            example.main([])
    assert Database(device="cpu").device == torch.device("cpu")
    assert ServeEngine(cfg, params, device="cpu").device == \
        torch.device("cpu")


def test_a_card_named_without_an_index_is_the_current_one(monkeypatch):
    """``"cuda"`` resolves to the current card's index, as a tensor made on
    it reports, so an engine given ``device="cuda"`` accepts parameters
    drawn there (no card is touched: both calls are stubbed)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert resolve_device("cuda") == torch.device("cuda", 3)
    assert resolve_device(None) == torch.device("cuda", 3)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    d = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="kernel"):
        ops.rank(d, 1, 4, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        radix_partition.rank(d, 1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        radix_partition.scatter(d.reshape(4, 1), d, 4, counts=d[:1])
    with pytest.raises(ValueError, match="CUDA"):
        cas_lock.cas(d, d, d, d, d)
    with pytest.raises(ValueError, match="CUDA"):
        grouped_agg.grouped_agg(d, d.float(), 4)
    with pytest.raises(ValueError, match="CUDA"):
        grouped_agg.grouped_sum_u32(d, d, 4)
    with pytest.raises(ValueError, match="kernel"):
        ops.grouped_sum_u32(d, d, 4, impl="kernel")
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="kernel"):
        ops.flash_attention(q, q, q, impl="kernel")
    x, bc, dt = torch.zeros((1, 4, 2, 8)), torch.zeros((1, 4, 16)), \
        torch.zeros((1, 4, 2))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan.ssd_scan(x, bc, bc, dt, torch.zeros(2))
    with pytest.raises(ValueError, match="kernel"):
        ops.ssd_scan(x, bc, bc, dt, torch.zeros(2), impl="kernel")
    before = ops.launch_counts()
    ops.cas(d.clone(), d, d, d + 1, d)            # plain on the CPU
    ops.grouped_agg(d, d.float(), 4)
    ops.flash_attention(q, q, q)
    ops.ssd_scan(x, bc, bc, dt, torch.zeros(2))
    assert ops.launch_counts() == before


WRAPPERS = (radix_partition, cas_lock, grouped_agg, flash_attention,
            ssd_scan)
_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)"
                     r"\s*)?(?:void\s+)?(\w+)\s*\(")


def _global_functions() -> set:
    names = set()
    for src in (ROOT / "src" / "repro_torch" / "kernels" / "csrc").glob(
            "*.cu"):
        names |= set(_GLOBAL.findall(src.read_text()))
    return names


def test_global_function_parser_finds_every_kernel():
    assert {"hist_kernel", "scan_kernel", "rank_kernel", "scatter_medium",
            "cas_kernel", "agg_kernel", "flash_bf16",
            "ssd_chunk_bf16", "ssd_chunk_f32"} <= _global_functions()


@pytest.mark.parametrize("mod", WRAPPERS,
                         ids=[m.__name__.rsplit(".", 1)[1] for m in WRAPPERS])
def test_listed_kernel_names_are_global_functions(mod):
    assert set(mod.KERNELS) == set(mod.launches)
    listed = {name for names in mod.KERNELS.values() for name in names}
    assert listed and listed <= _global_functions(), \
        listed - _global_functions()


def test_the_dry_run_allocates_nothing_and_launches_no_kernel(monkeypatch):
    """One reduced MoE train cell on a (2, 4) meta mesh (its RRJ's shard
    bodies included): every tensor any op makes, on any thread, is on the
    meta device or smaller than the smallest parameter, and no kernel
    library of ``kernels/`` is loaded."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.launch import dryrun, roofline
    cfg = reduce_config(get_config("deepseek-v2-236b"))
    smallest = min(math.prod(s) for _, s in roofline._walk(
        api.param_shapes(cfg)))
    made = []
    record = roofline.StepCounter._record

    def watch(self, func, args, kwargs, out):
        made.extend((t.device.type, t.numel())
                    for t in roofline._tensors(out))
        return record(self, func, args, kwargs, out)

    monkeypatch.setattr(roofline.StepCounter, "_record", watch)
    entered = []
    for mod in WRAPPERS:            # every launch loads its library first
        monkeypatch.setattr(mod, "_load", lambda m=mod: entered.append(m))
    before = ops.launch_counts()
    row = dryrun.dry_cell("deepseek-v2-236b", "train_4k",
                          make_host_mesh(2, 4, device="meta"), cfg=cfg,
                          shape=ShapeCfg("train_4k", 64, 8, "train"),
                          verbose=False, microbatches=2)
    assert row["roofline"]["collective_bytes_per_chip"]["all-to-all"] > 0
    assert len(made) > 1000
    off_meta = [(d, n) for d, n in made if d != "meta"]
    assert all(n < smallest for _, n in off_meta), off_meta[:5]
    assert not entered and ops.launch_counts() == before
