"""Training on the card: the trainer in each sync mode, and the gradient
check of the kernel path.

The library behind ``chip_smoke.py`` phase ``train``; it has no CLI of
its own (``repro_torch.launch.train`` is the user's entry point).  For one
architecture (``config(arch, layers)`` cuts the depth for a quick look),
with f32 master parameters drawn on the device from seed 0:

* :func:`train`: a fresh :class:`~repro_torch.train.trainer.Trainer` in
  one sync mode takes ``steps`` steps through ``Trainer.run`` on
  ``SyntheticLM`` batches; it reports the loss of every step, seconds a
  step and tokens/s, the parameter server's pull and push times (CUDA
  events around each call), peak memory, the kernels' launches over the
  run (counted between a reset and a read), every push's route bytes, and,
  after the timed steps, one more step under ``torch.profiler`` (behind
  a warm-up step) split by where its device time goes (:func:`split`).
* :func:`leaf_check`: a gradient tree against another (the kernel path's
  against the plain path's), leaf by leaf; :func:`leaf_names` names the
  leaves.
* :func:`route_bytes`: the bytes one push routes for (S, L, block); the
  CPU tests hold it to the JAX package's counter at mamba2-370m's (S, L).
"""
from __future__ import annotations

import bisect
import dataclasses
import shutil
import statistics
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.kernels import flash_attention, ops, ssd_scan
from repro_torch.models import api
from repro_torch.train import train_step as ts
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves

# the profiler labels a step's device time is split by, innermost first
LABELS = ("ps.compress", "ps.route", "ps.decompress", "ps.install",
          ops.PLAIN_BACKWARD, ts.OPTIMIZER)
TOP = 15                 # device kernels listed by time in a split
PROFILED_STEPS = 2       # after the timed steps: a warm-up, then the profiled


def config(arch: str, layers=None):
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def masters(cfg, device):
    """f32 master parameters drawn on ``device`` from seed 0."""
    return api.init_params(cfg, torch.Generator(device).manual_seed(0),
                           device=device)


def route_bytes(num_shards: int, shard_len: int, block: int,
                compress: bool = True) -> int:
    """Bytes one push routes at n = 1: S requests of one packed row each,
    the int8 codes four to a 32-bit lane and one f32 scale a block (or
    the raw f32 row), plus the valid lane."""
    lanes = (-(-shard_len // 4) + shard_len // block) if compress \
        else shard_len
    return num_shards * 4 * (lanes + 1)


def _timed(fn, dev, into: list):
    """``fn`` with each call's time between CUDA events appended to
    ``into`` (read after the next synchronize)."""
    def call(*a, **kw):
        b, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        b.record()
        out = fn(*a, **kw)
        e.record()
        into.append((b, e))
        return out
    return call if dev.type == "cuda" else fn


def _ms(pairs) -> list:
    torch.cuda.synchronize()
    return [b.elapsed_time(e) for b, e in pairs]


def split(prof) -> dict:
    """A profiled step's device time (ms) by where it went: the port's
    forward kernels (by device-kernel name); each labeled range (the
    innermost label whose host range holds the launch of a device kernel:
    the plain backward, the optimizer, the PS's compress, route,
    decompress and install); and the rest by name, matrix products and
    elementwise (everything else: elementwise passes, reductions,
    copies).  ``by_label`` splits each label by kind too; ``top``: the
    device kernels taking the most time, with their time and count.  It
    reads the profiler's raw events (building its Python events for a
    training step's ~10^5 operations takes half a minute)."""
    port = set(flash_attention.KERNELS["flash"]) | set(
        ssd_scan.KERNELS["ssd"])

    def kind(name):
        if any(k in name for k in port):
            return "kernel"
        low = name.lower()
        if any(w in low for w in ("gemm", "xmma", "cutlass", "cublas",
                                  "nvjet")):
            return "matmul"
        return "elementwise"

    cuda = torch.autograd.DeviceType.CUDA
    kernels, launch, ranges = [], {}, {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            # a labeled range also shows on the device's timeline: not work
            if not (e.is_user_annotation() or name in LABELS
                    or name.startswith("ProfilerStep")):
                kernels.append((name, e.duration_ns() / 1e6,
                                e.linked_correlation_id()))
        elif name in LABELS:
            ranges.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.end_ns(), name))
        elif e.linked_correlation_id() > 0:
            launch[e.linked_correlation_id()] = (e.start_thread_id(),
                                                 e.start_ns())
    for rs in ranges.values():
        rs.sort()

    def label(corr):
        """The innermost label range holding the kernel's launch."""
        tid, t = launch.get(corr, (None, None))
        rs = ranges.get(tid, ())
        i = bisect.bisect_right(rs, (t, float("inf"), "")) - 1
        while i >= 0:
            s0, s1, name = rs[i]
            if s0 <= t <= s1:
                return name
            i -= 1
        return None

    by_kind: dict = {}
    by_name: dict = {}
    by_label: dict = {}
    for name, ms, corr in kernels:
        k = kind(name)
        by_kind[k] = by_kind.get(k, 0.0) + ms
        n = by_name.setdefault(name[:100], [0.0, 0])
        n[0] += ms
        n[1] += 1
        lab = label(corr) if k != "kernel" else None
        if lab is not None:
            d = by_label.setdefault(lab, {})
            d[k] = d.get(k, 0.0) + ms
    ms = {"kernel": by_kind.get("kernel", 0.0)}
    for lab, d in by_label.items():
        ms[lab] = sum(d.values())
    for k in ("matmul", "elementwise"):
        ms[k] = by_kind.get(k, 0.0) - sum(d.get(k, 0.0)
                                           for d in by_label.values())
    return {"device_ms": sum(by_kind.values()), "ms": ms,
            "by_label": by_label,
            "top": sorted(([n, v[0], v[1]] for n, v in by_name.items()),
                          key=lambda r: -r[1])[:TOP]}


def train(cfg, *, mode: str, steps: int, batch: int, seq: int, device,
          ckpt_dir, compress: bool = True) -> dict:
    """``steps`` steps of a fresh trainer in sync mode ``mode``."""
    dev = torch.device(device)
    tcfg = TrainerConfig(steps=steps, global_batch=batch, seq_len=seq,
                         checkpoint_dir=str(ckpt_dir), log_every=1,
                         checkpoint_every=10 ** 9, sync_mode=mode,
                         ps_compress=compress)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    tr = Trainer(cfg, tcfg, device=dev)
    tr.init(params=masters(cfg, dev))
    pulls, pushes, push_bytes = [], [], []
    if tr.ps is not None:
        tr.ps.pull = _timed(tr.ps.pull, dev, pulls)
        push = _timed(tr.ps.push, dev, pushes)

        def counted_push(*a, **kw):
            before = tr.ps.fabric_stats().get("route", {}).get("bytes", 0)
            out = push(*a, **kw)
            push_bytes.append(tr.ps.fabric_stats()["route"]["bytes"]
                              - before)
            return out
        tr.ps.push = counted_push
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    log = tr.run()
    launches = ops.launch_counts()
    secs = time.perf_counter() - t0
    out = {"device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"),
           "mode": mode, "compress": compress, "steps": steps,
           "batch": batch, "seq": seq, "losses": [l for _, l in log],
           "step_s": list(tr.step_times), "run_s": secs,
           "launches": launches}
    later = tr.step_times[1:] or tr.step_times
    out["median_step_s"] = statistics.median(later)
    out["tokens_per_s"] = batch * seq / out["median_step_s"]
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    if tr.ps is not None:
        out.update(epoch=tr.ps.epoch, num_shards=tr.ps.num_shards,
                   shard_len=tr.ps.shard_len,
                   push_route_bytes=list(push_bytes),
                   wire_bytes_per_push=tr.ps.wire_bytes_per_push(),
                   fabric=tr.ps.fabric_stats(), comm=tr.comm_log[-1]
                   if tr.comm_log else None)
        if dev.type == "cuda":
            out["pull_ms"] = _ms(pulls)
            out["push_ms"] = _ms(pushes)
    if dev.type == "cuda":
        # after the timed run: a warm-up step, then the profiled one
        from torch.profiler import ProfilerActivity, profile, schedule
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       schedule=schedule(wait=0, warmup=1, active=1,
                                         repeat=1))
        with prof:
            for _ in range(PROFILED_STEPS):
                tr.train_step()
                prof.step()
        t1 = time.perf_counter()
        out["profile"] = split(prof)
        out["profiled_step"] = tr.step
        out["profile_s"] = time.perf_counter() - t1
    del tr
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return out


def first_batch(cfg, *, batch: int, seq: int, device) -> dict:
    """The trainer's first batch (``SyntheticLM`` step 0) on ``device``."""
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                       global_batch=batch)
    return {k: torch.from_numpy(v).to(device)
            for k, v in data.next_batch().items()}


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    """rms(got - want) / rms(want), in f64."""
    d = (got.double() - want.double()).square().mean().sqrt()
    w = want.double().square().mean().sqrt()
    return float(d / w) if float(w) > 0 else float(d)


def leaf_names(tree, prefix: str = "") -> list:
    """The "/"-joined key path of each leaf of a dict tree, in flatten
    order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}/{k}")]
    return [prefix]


def leaf_check(a, b) -> dict:
    """Per-leaf rel_rms of gradient tree ``a`` against ``b`` (the plain
    path's): the worst leaf and its index in flatten order."""
    per = [rel_rms(x, y) for x, y in zip(leaves(a), leaves(b))]
    return {"per_leaf": per, "max": max(per),
            "worst_leaf": per.index(max(per))}
