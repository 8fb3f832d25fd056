"""Dry-run every (arch x shape) cell on the meta device (the port's
counterpart of ``repro.launch.dryrun``).

JAX lowers and compiles each cell's jitted step for the production mesh
and reads XLA's memory and cost analyses.  PyTorch has no compiled step
of that shape, so the port describes a cell from shapes alone:

  - **argument bytes per device**: every argument of the step
    (parameters in bf16 for serving, f32 masters and the optimizer state
    for training, the batch, the decode state) through the shardings of
    ``train/train_step.py`` (``param_shardings``, ``opt_state_shardings``,
    ``batch_shardings``, ``decode_state_shardings``) and
    ``NamedSharding.shard_shape``: JAX's ``argument_size_in_bytes``;
  - **the step**, run once on meta tensors (parameters built from
    ``api.param_shapes``) under ``make_policy(mesh, shape_kind=...)`` on
    ``make_production_mesh(device="meta")``, counted by
    ``launch/roofline.py``'s :class:`StepCounter` (a meta mesh runs the
    MoE dispatch's shard body once, standing for every shard: on shapes
    alone all shards do the same work);
  - **peak live bytes**: the eager step's storages tracked as they are
    made and freed, above its arguments: the counterpart of JAX's
    ``temp_size_in_bytes``, stated as one device's that runs the whole
    eager step (``temp_bytes`` takes the kernelized peak, which leaves out
    what a kernel's plain version makes inside itself).

Nothing here allocates a CPU or CUDA tensor of a parameter's size or
launches a kernel: on the meta device every wrapper of ``kernels/ops.py``
runs its plain version, which makes no storage.  A cell that
``supports_shape`` refuses is a ``skipped`` row with JAX's reason.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --out dryrun.jsonl
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, supports_shape
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api, lm
from repro_torch.sharding import make_policy, set_policy
from repro_torch.sharding import policy as _policy
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import make_optimizer
from repro_torch.tree import map_axes

META = torch.device("meta")


def input_specs(arch: str, shape_name: str) -> dict:
    """(shape, dtype) stand-ins for every model input of a cell.
    train/prefill: tokens and labels (B, S) int32 (and a VLM's or
    whisper's modality features (B, M, modality_dim) f32); decode: tokens
    (B, 1), the decode state coming from ``api.decode_cache_shape``."""
    return input_spec_shapes(get_config(arch), SHAPES[shape_name])


def input_spec_shapes(cfg, shape, tokens_dtype=torch.int32) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        spec = {"tokens": ((b, s), tokens_dtype),
                "labels": ((b, s), tokens_dtype)}
        if cfg.modality_dim:
            spec["modality"] = ((b, cfg.num_modality_tokens,
                                 cfg.modality_dim), torch.float32)
        return spec
    return {"tokens": ((b, 1), tokens_dtype)}


def _policy_kind(shape) -> str:
    if shape.kind == "decode":
        return "long_decode" if shape.name == "long_500k" else "decode"
    return "train"


# gradient-accumulation default: big archs split the per-device batch
MICROBATCHES = {"jamba-1.5-large-398b": 4, "llama4-maverick-400b-a17b": 4,
                "deepseek-v2-236b": 4, "llama-3.2-vision-90b": 4}


def apply_opts(opts: str) -> dict:
    """The §Perf toggles: 'ce_chunk=512,decode_tp,microbatches=2'.
    ``ce_chunk`` sets ``lm.CE_CHUNK`` (the streamed cross-entropy),
    ``decode_tp`` the policy's ``DECODE_TP``; ``microbatches`` is
    returned.  Any other toggle raises ``ValueError``, JAX's
    ``rs_outputs`` too: it asks JAX's partitioner to reduce-scatter block
    outputs over 'model', and the port has no partitioner (its
    ``constrain`` moves no data, ``models/blocks.py``)."""
    out = {}
    for item in (opts or "").split(","):
        if not item:
            continue
        k, _, v = item.partition("=")
        if k == "ce_chunk":
            lm.CE_CHUNK = int(v or 512)
        elif k == "decode_tp":
            _policy.DECODE_TP = True
        elif k == "microbatches":
            out["microbatches"] = int(v)
        else:
            raise ValueError(k)
    return out


# ------------------------------------------------------------- arguments --

_walk = roofline._walk


def _leaf(x):
    """(shape, dtype) of a meta tensor or a (shape, dtype) pair."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    return tuple(x[0]), x[1]


def tree_shard_bytes(leaves, shardings) -> int:
    """Bytes of one device's blocks of a tree of (shape, dtype) leaves (or
    meta tensors) under a tree of shardings of the same structure."""
    sh = dict(_walk(shardings))
    total = 0
    for path, leaf in _walk(leaves):
        shape, dtype = _leaf(leaf)
        total += (math.prod(sh[path].shard_shape(shape))
                  * torch.empty((), dtype=dtype).element_size())
    return total


def _meta_tree(tree):
    if isinstance(tree, dict):
        return {k: _meta_tree(v) for k, v in tree.items()}
    shape, dtype = _leaf(tree)
    return torch.empty(shape, dtype=dtype, device=META)


def cell_arguments(cfg, shape, policy, tokens_dtype=torch.int32) -> tuple:
    """(the step's arguments as meta tensors, the parameters, their bytes
    per device); tokens (and labels) of ``tokens_dtype``."""
    train = shape.kind == "train"
    pdtype = torch.float32 if train else torch.bfloat16
    pshapes = map_axes(lambda s: (s, pdtype), api.param_shapes(cfg))
    params = _meta_tree(pshapes)
    nbytes = tree_shard_bytes(pshapes, ts.param_shardings(cfg, policy))
    if shape.kind == "decode":
        b = shape.global_batch
        sshapes = api.decode_cache_shape(cfg, b, shape.seq_len)
        nbytes += tree_shard_bytes(sshapes, ts.decode_state_shardings(
            cfg, policy, sshapes))
        tok = {"tokens": ((b, 1), tokens_dtype)}
        nbytes += tree_shard_bytes(tok, {"tokens": policy.sharding(
            ("batch", None))})
        return {"state": _meta_tree(sshapes),
                "tokens": _meta_tree(tok)["tokens"]}, params, nbytes
    batch = input_spec_shapes(cfg, shape, tokens_dtype)
    if not train:        # a prefill step reads no labels, and JAX's jit
        del batch["labels"]            # keeps no argument a step ignores
    nbytes += tree_shard_bytes(batch, ts.batch_shardings(cfg, policy, batch))
    args = {"batch": _meta_tree(batch)}
    if train:
        opt = make_optimizer(cfg.optimizer)
        ostate = opt.init(params)
        nbytes += tree_shard_bytes(ostate, ts.opt_state_shardings(
            cfg, policy, opt, ostate))
        args.update(opt=opt, opt_state=ostate)
    return args, params, nbytes


# ------------------------------------------------------------------ cell --

def count_cell(cfg, shape, mesh=None, *, microbatches: int = 1,
               tokens_dtype=torch.int32) -> tuple:
    """Run one step of ``shape`` on meta tensors under
    ``make_policy(mesh, ...)`` (no policy when ``mesh`` is None: one
    device) and count it.  Tokens are ``tokens_dtype`` (JAX's int32; the
    card's prompts are int64).  Returns (the counter, argument bytes per
    device, seconds taken)."""
    policy = (None if mesh is None
              else make_policy(mesh, shape_kind=_policy_kind(shape)))
    t0 = time.perf_counter()
    with set_policy(policy):
        if policy is None:
            from repro_torch.launch.mesh import make_host_mesh
            one = make_policy(make_host_mesh(1, 1, device=META),
                              shape_kind=_policy_kind(shape))
            args, params, nbytes = cell_arguments(cfg, shape, one,
                                                  tokens_dtype)
        else:
            args, params, nbytes = cell_arguments(cfg, shape, policy,
                                                  tokens_dtype)
        with roofline.StepCounter() as count:
            if shape.kind == "train":
                step = ts.build_train_step(cfg, args["opt"],
                                           microbatches=microbatches)
                step(params, args["opt_state"], args["batch"])
            elif shape.kind == "prefill":
                ts.build_prefill_step(cfg)(params, args["batch"])
            else:
                ts.build_serve_step(cfg)(params, args["state"],
                                         args["tokens"])
    if policy is not None:
        count.param_gathers = roofline.param_gathers(
            cfg, policy, train=shape.kind == "train",
            microbatches=microbatches)
    return count, nbytes, time.perf_counter() - t0


def dry_cell(arch: str, shape_name: str, mesh, *, verbose=True,
             microbatches=None, roofline_row: bool = True, cfg=None,
             shape=None) -> dict:
    """One (arch x shape) cell on ``mesh``: its row, or a skip.  ``cfg``
    and ``shape`` stand in for the arch's config and the shape's sizes
    (the tests' reduced cells)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    ok, why = supports_shape(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}
    if microbatches is None:
        microbatches = MICROBATCHES.get(arch, 1)
    mb = microbatches if shape.kind == "train" else 1
    count, nbytes, secs = count_cell(cfg, shape, mesh, microbatches=mb)
    stats = {"arch": arch, "shape": shape_name, "mesh": dict(mesh.shape),
             "kind": shape.kind, "microbatches": mb,
             "count_s": round(secs, 1),
             "memory": {"argument_bytes": nbytes,
                        "temp_bytes": count.peak_live_k,
                        "peak_live_bytes": count.peak_live,
                        "peak_live_bytes_kernelized": count.peak_live_k}}
    if roofline_row:
        stats["roofline"] = roofline.analyze(cfg, shape, count, mesh.size)
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {stats['mesh']}: "
              f"counted in {secs:.1f}s")
        print(f"  memory: {stats['memory']}")
        if roofline_row:
            r = dict(stats["roofline"])
            r.pop("memory_breakdown", None)
            print(f"  roofline: {json.dumps(r)}")
    return stats


def run_cell(arch, shape_name, multi_pod, *, roofline=True):
    mesh = make_production_mesh(multi_pod=multi_pod, device=META)
    stats = dry_cell(arch, shape_name, mesh, roofline_row=roofline)
    if "skipped" in stats:
        print(f"[dryrun] SKIP {arch} x {shape_name}: {stats['skipped']}")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--out", default=None, help="append results to this JSONL")
    ap.add_argument("--opts", default="",
                    help="perf toggles: ce_chunk=512,decode_tp,"
                         "microbatches=N")
    args = ap.parse_args(argv)
    opt_kw = apply_opts(args.opts)
    if opt_kw.get("microbatches"):
        MICROBATCHES.clear()
        for a in ARCH_IDS:
            MICROBATCHES[a] = opt_kw["microbatches"]

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    stats = run_cell(arch, shape, mp,
                                     roofline=not args.no_roofline)
                    if args.opts and "skipped" not in stats:
                        stats["opts"] = args.opts
                except Exception as e:   # noqa: BLE001 - a failed cell row
                    import traceback
                    traceback.print_exc()
                    stats = {"arch": arch, "shape": shape, "multi_pod": mp,
                             "error": f"{type(e).__name__}: {e}"}
                    failures.append(stats)
                stats["multi_pod"] = mp
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(stats) + "\n")
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES")
        return 1
    print("[dryrun] all requested cells passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
