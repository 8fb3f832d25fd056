"""Run a cell with a planted control or fault (``faults.py``), or with
none, on several seeds in one process: the readings the limits of
``correct`` are set from.

    python3 nambench/controls.py --workload <cell> --plant <none|control|fault> \\
        --seconds <s> --seeds <n> [<n> ...]

Prints one JSON line a seed: the plant, the seed, ``correct`` and every
number compared with its limit.  The benchmark's own runs plant nothing.
A cell withdrawn to ``later.json`` runs here too.
"""
from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    import argparse

    import torch

    from nambench import faults
    from nambench.harness import run_cell
    from nambench.spec import Spec
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--plant", default="none")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    spec = Spec(later=True)
    kind = spec.traffic(spec.cell(args.workload).traffic)["kind"]
    for seed in args.seeds:
        planted = (None if args.plant == "none"
                   else faults.plant(kind, args.plant))
        res = run_cell(spec, args.workload, seed, args.seconds, False,
                       planted=planted, started=time.perf_counter())
        print(json.dumps({"workload": args.workload, "plant": args.plant,
                          "seed": seed, "correct": res["correct"],
                          "checks": res["checks"],
                          "attempted": res["attempted"],
                          "failed": res["failed"],
                          "metrics": res["metrics"]}), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    root = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(root / "src"), str(root)]
    sys.exit(main())
