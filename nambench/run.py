"""Run one cell of ``BENCHMARK.json`` once.

    python3 nambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m nambench.run`` from the checkout's root).  The port is
imported from the checkout's ``src``; its kernel libraries build once
into ``build/torch_kernels`` inside the checkout.  Exit codes: 0 with a
result line; 2 without a card (or with fewer than the cell asks for);
3 when the run loaded JAX or the JAX package; anything else on a fault.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _paths():
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    # caches a library might open stay inside the checkout, at fixed paths
    cache = ROOT / "build" / "nambench-cache"
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


if __name__ == "__main__":
    _paths()
    from nambench.harness import main
    sys.exit(main())
