"""A small copy of the benchmark for the CPU: every cell of
``BENCHMARK.json``, and the cells withdrawn to ``later.json`` entered as
data alone, at sizes a test run holds (the join's relations of
2**16 rows, so float32 sums round; 2 000 products of 4 words; waves of
64), with the real metric readers and kinds."""
import json
import shutil
from pathlib import Path

import pytest

from nambench.spec import PACKAGE, ROOT, Spec, with_later

SMALL = {
    ("configs", "nam-olap-128m"): {"tuples_per_node": 1 << 16},
    ("configs", "nam-oltp-tpcw"): {"num_products": 2000, "payload_words": 4,
                                   "insert_rows": 64 * 4 * 400},
    ("traffic", "olap-agg-large-g"): {"groups": [64, 1024, 4096]},
    ("traffic", "oltp-checkout"): {"sessions_per_wave": 64},
    ("traffic", "oltp-checkout-zipf"): {"sessions_per_wave": 64},
}


def small_copy(dest: Path) -> Spec:
    """``BENCHMARK.json`` and the data files under ``dest``, the sizes
    cut as :data:`SMALL` says, ``later.json``'s cells entered."""
    pkg = dest / "nambench"
    for folder in ("configs", "traffic", "metrics"):
        shutil.copytree(PACKAGE / folder, pkg / folder)
    for (folder, name), change in SMALL.items():
        path = pkg / folder / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()),
                                    **change}))
    raw = with_later(json.loads((ROOT / "BENCHMARK.json").read_text()))
    (dest / "BENCHMARK.json").write_text(json.dumps(raw))
    return Spec(dest, pkg)


@pytest.fixture
def small(tmp_path) -> Spec:
    return small_copy(tmp_path)
