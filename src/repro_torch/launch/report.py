"""Render the dry-run's tables from its JSONL rows (the port's counterpart
of ``repro.launch.report``).

  PYTHONPATH=src python -m repro_torch.launch.report dryrun.jsonl

Rows are ``launch/dryrun.py``'s: the mesh comes from each row, the
memory columns are the argument bytes a device holds and the eager
step's peak live bytes (one device running the whole step), and the
roofline columns are ``launch/roofline.py``'s per-chip terms on the H100.
"""
from __future__ import annotations

import argparse
import json
from collections import OrderedDict


def load(paths):
    rows = OrderedDict()
    for path in paths:
        with open(path) as f:
            for line in f:
                d = json.loads(line)
                key = (d.get("arch"), d.get("shape"), d.get("multi_pod",
                                                            False))
                rows[key] = d          # later files override (hillclimbs)
    return rows


def fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b/2**30:.1f}G"


def mesh_name(d, multi_pod: bool) -> str:
    """'16x16' from the row's mesh, or the production mesh's for a row
    that has none (a skip or an error)."""
    mesh = d.get("mesh")
    if mesh:
        return "x".join(str(v) for v in mesh.values())
    return "2x16x16" if multi_pod else "16x16"


def dryrun_table(rows):
    out = ["| arch | shape | mesh | count | args/dev | peak live (step) | "
           "GFLOP/chip | coll GB/chip |",
           "|---|---|---|---|---|---|---|---|"]
    for (arch, shape, mp), d in rows.items():
        mesh = mesh_name(d, mp)
        if "skipped" in d:
            out.append(f"| {arch} | {shape} | {mesh} | SKIP | - | - | - | - |")
            continue
        if "error" in d:
            out.append(f"| {arch} | {shape} | {mesh} | ERROR | - | - | - | - |")
            continue
        r = d.get("roofline", {})
        coll = r.get("collective_bytes_per_chip", {}).get("total")
        gath = r.get("param_gather_bytes_per_chip", {}).get("total", 0.0)
        out.append(
            f"| {arch} | {shape} | {mesh} | {d['count_s']}s "
            f"| {fmt_bytes(d['memory']['argument_bytes'])} "
            f"| {fmt_bytes(d['memory']['temp_bytes'])} "
            f"| {r.get('step_flops_per_chip', 0)/1e9:,.0f} "
            f"| {'-' if coll is None else f'{(coll + gath)/1e9:.1f}'} |")
    return "\n".join(out)


LEVERS = {
    "memory_s": "the hand-written kernels on more of the step; fewer eager "
                "passes (fused elementwise work)",
    "collective_s": "overlap the FSDP gathers with compute; bf16 "
                    "collectives",
    "compute_s": "less recompute (remat policy); CUDA graphs for decode's "
                 "launches",
}


def roofline_table(rows, mesh: str = "16x16"):
    out = ["| arch | shape | compute_s | memory_s | collective_s | dominant "
           "| MODEL_FLOPs/step | roofline frac | kernelized frac "
           "| next lever |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape, mp), d in rows.items():
        if "roofline" not in d or mesh_name(d, mp) != mesh:
            continue
        r = d["roofline"]
        out.append(
            f"| {arch} | {shape} | {r['compute_s']:.3f} | {r['memory_s']:.3f}"
            f" | {r['collective_s']:.3f} | {r['dominant'].replace('_s','')}"
            f" | {r['useful_flop_ratio']:.2f}"
            f" | {r['roofline_fraction']:.3f}"
            f" | {r['roofline_fraction_kernelized']:.3f}"
            f" | {LEVERS[r['dominant']]} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("jsonl", nargs="+")
    ap.add_argument("--mode", default="both",
                    choices=("dryrun", "roofline", "both"))
    ap.add_argument("--mesh", default="16x16",
                    help="the mesh whose rows the roofline table shows")
    args = ap.parse_args(argv)
    rows = load(args.jsonl)
    if args.mode in ("dryrun", "both"):
        print("## Dry-run\n")
        print(dryrun_table(rows))
        print()
    if args.mode in ("roofline", "both"):
        print(f"## Roofline ({args.mesh}, H100)\n")
        print(roofline_table(rows, args.mesh))


if __name__ == "__main__":
    main()
