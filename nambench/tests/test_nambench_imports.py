"""What the benchmark loads, on the CPU:

  * no module under ``nambench/`` imports ``jax``, ``jaxlib``, ``flax``,
    the JAX package ``repro`` or its ``benchmarks`` (top-level names
    compared whole: ``repro_torch`` is not ``repro``);
  * the references import nothing of the port;
  * a process that imports the whole harness, every kind, every reader
    and the port's entry points holds none of them in ``sys.modules``,
    and one that imports the references holds no ``repro_torch``.
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from nambench.spec import PACKAGE, ROOT

FILES = sorted(PACKAGE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_imports_no_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((PACKAGE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN | {"repro_torch", "nambench"}
           and not m.startswith("nambench.reference")]
    assert not bad, f"{path} imports {bad}"


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{ROOT / 'src'}:{ROOT}"})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_the_harness_loads_no_jax():
    code = "\n".join(
        ["import nambench.harness, nambench.trace, nambench.faults",
         "import nambench.controls, nambench.run",
         "from nambench.spec import Spec",
         "s = Spec()",
         "[s.reader(m.name) for m in s.end_to_end + s.per_layer]",
         "import nambench.kinds.olap_join, nambench.kinds.olap_agg",
         "import nambench.kinds.oltp_checkout",
         "import repro_torch.db, repro_torch.kernels.build"])
    assert not _loaded(code) & FORBIDDEN


def test_the_references_load_no_port():
    loaded = _loaded("import nambench.reference.olap, "
                     "nambench.reference.oltp")
    assert "repro_torch" not in loaded and not loaded & FORBIDDEN
