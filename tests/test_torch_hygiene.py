"""The port stands alone and runs on the card unless asked otherwise.

  * no module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
    ``jax`` or anything of the JAX package ``repro``;
  * with no card present, every entry point that was not given
    ``device=`` raises instead of running on the CPU;
  * a kernel wrapper given a CPU tensor raises before it builds anything.
"""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch import fabric
from repro_torch._bits import resolve_device
from repro_torch.core import rsi
from repro_torch.db import Database
from repro_torch.kernels import cas_lock, grouped_agg, ops, radix_partition

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
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "rsi.py", "router.py", "ops.py"} <= names
    assert len(list((ROOT / "src" / "repro_torch" / "kernels" / "csrc")
                    .glob("*.cu"))) == 3


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        Database()
    with pytest.raises(RuntimeError, match="CUDA"):
        fabric.LocalTransport()
    with pytest.raises(RuntimeError, match="CUDA"):
        rsi.init_store(rsi.StoreCfg(num_records=4))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert Database(device="cpu").device == torch.device("cpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    d = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="kernel"):
        ops.rank(d, 1, 4, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        radix_partition.rank(d, 1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        radix_partition.scatter(d.reshape(4, 1), d, 4)
    with pytest.raises(ValueError, match="CUDA"):
        cas_lock.cas(d, d, d, d, d)
    with pytest.raises(ValueError, match="CUDA"):
        grouped_agg.grouped_agg(d, d.float(), 4)
    with pytest.raises(ValueError, match="CUDA"):
        grouped_agg.grouped_sum_u32(d, d, 4)
    with pytest.raises(ValueError, match="kernel"):
        ops.grouped_sum_u32(d, d, 4, impl="kernel")
    before = ops.launch_counts()
    ops.cas(d.clone(), d, d, d + 1, d)            # plain on the CPU
    ops.grouped_agg(d, d.float(), 4)
    assert ops.launch_counts() == before
