"""The port stands alone and runs on the card unless asked otherwise.

  * no module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
    ``jax``, anything of the JAX package ``repro`` or its ``benchmarks``;
  * with no card present, every entry point that was not given
    ``device=`` (the database, the transport, the store, the model's
    parameters, the serving engine and its launcher, the parameter
    server, the trainer and its launcher) raises instead of running on
    the CPU;
  * a kernel wrapper given a CPU tensor raises before it builds anything;
  * every device-kernel name a wrapper lists (``KERNELS``, which the
    profiling code reads) is a ``__global__`` function of the sources.
"""
import ast
import re
from pathlib import Path

import pytest
import torch

from repro_torch import fabric
from repro_torch._bits import resolve_device
from repro_torch.analytics import ParameterServer
from repro_torch.core import rsi
from repro_torch.configs import get_config, reduce_config
from repro_torch.db import Database
from repro_torch.kernels import (cas_lock, flash_attention, grouped_agg, ops,
                                 radix_partition, ssd_scan)
from repro_torch.launch import serve as launch_serve
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
            "bench/fig_scale.py"} <= names
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
    assert Database(device="cpu").device == torch.device("cpu")
    assert ServeEngine(cfg, params, device="cpu").device == \
        torch.device("cpu")


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
            "ssd_kernel"} <= _global_functions()


@pytest.mark.parametrize("mod", WRAPPERS,
                         ids=[m.__name__.rsplit(".", 1)[1] for m in WRAPPERS])
def test_listed_kernel_names_are_global_functions(mod):
    assert set(mod.KERNELS) == set(mod.launches)
    listed = {name for names in mod.KERNELS.values() for name in names}
    assert listed and listed <= _global_functions(), \
        listed - _global_functions()
