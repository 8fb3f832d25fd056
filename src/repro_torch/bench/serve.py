"""Model serving on the card: a prefill step and the dense engine.

The library behind ``chip_smoke.py`` phase ``serve``.  For one
architecture at its full published config (``config(arch, layers)`` cuts
the depth for a quick look), with bf16 weights drawn on the device from
seed 0:

* :func:`prefill`: ``build_prefill_step`` on a (batch, seq) prompt of
  random tokens, one warm-up step, then ``iters`` timed steps (host clock
  around a synchronized step), each between a reset and a read of the
  kernel launch counts; the full-depth last-position logits of the kernel
  path against the plain path (``impl="plain"``); one profiled step.
* :func:`layer_check`: every layer's kernel against its plain version on
  that layer's own inputs in a kernel-path forward, at every position.
* :func:`f32_witness`: the full-depth logits of both paths with f32
  weights and activations, and of the plain path against itself with its
  embedding nudged.
* :func:`engine`: ``ServeEngine(slots, max_seq)`` runs ``requests``
  requests (prompts of 16-64 tokens from a numpy seed, ``max_new`` new
  tokens each) in waves of ``slots``; launches are counted per wave.
"""
from __future__ import annotations

import dataclasses
import statistics
import time

import numpy as np
import torch

from repro_torch._bits import resolve_device
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention, ops, ssd_scan
from repro_torch.models import api, lm
from repro_torch.serving import Request, ServeEngine
from repro_torch.train.train_step import build_prefill_step

# (batch, seq) of the prefill path per architecture
PREFILL = {"glm4-9b": (1, 8192), "mamba2-370m": (8, 8192)}
SLOTS, MAX_SEQ, REQUESTS, MAX_NEW = 8, 1024, 16, 32
PROMPT_LENS = (16, 64)
KERNELS = ("flash_attention", "ssd_scan")     # the model path's kernels
NUDGE = 2.0 ** -20     # relative, about the kernel and plain paths' f32
                       # difference in one layer (the f32 flash sweep's
                       # error, 9.5e-7)


def config(arch: str, layers=None):
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def weights(cfg, *, device=None, dtype=torch.bfloat16):
    """Parameters drawn on the device from seed 0."""
    device = resolve_device(device)
    return api.init_params(cfg, torch.Generator(device).manual_seed(0),
                           dtype=dtype, device=device)


def prompt(cfg, batch: int, seq: int, device) -> torch.Tensor:
    """(batch, seq) random tokens from seed 1."""
    g = torch.Generator(device).manual_seed(1)
    return torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                         device=device)


@torch.inference_mode()
def last_logits(cfg, params, tokens, *, impl=None) -> torch.Tensor:
    """f32 logits of the last position (the prefill step's argmax input);
    the head runs on that position alone."""
    x = lm.forward_hidden(cfg, params, tokens, impl=impl)
    return lm._head(cfg, params, x[:, -1:])[:, 0].float()


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest over rows (every index but the last) of rms(got - want)
    / rms(want) along the last axis: a difference measured against the
    size of the values it compares, row by row, so that rows of small
    values are held as tightly as rows of large ones."""
    want = want.float()
    num = (got.float() - want).pow(2).mean(-1).sqrt()
    den = want.pow(2).mean(-1).sqrt().clamp_min(1e-30)
    return float((num / den).max())


def compare(k: torch.Tensor, pl: torch.Tensor) -> dict:
    """Kernel-path logits k against plain-path logits pl, (B, V)."""
    return {"max_abs_diff": float((k - pl).abs().max()),
            "max_abs_logit": float(pl.abs().max()),
            "finite": bool(torch.isfinite(k).all()),
            "argmax_agree": float((k.argmax(-1) == pl.argmax(-1))
                                  .float().mean())}


def _sync_s(fn, dev):
    """(fn(), seconds) on the host clock, the device synchronized on both
    sides.  The CPU runs it only to rehearse the code at a small size: a
    time taken there says nothing of the card."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None


def prefill(cfg, params, *, batch: int, seq: int, iters: int = 3,
            profiled: bool = True) -> dict:
    """Time the prefill step; compare its full-depth logits with the plain
    path's; profile one step (``profiled``, the card only)."""
    dev = params["embed"].device
    tokens = prompt(cfg, batch, seq, dev)
    step = build_prefill_step(cfg)
    batch_in = {"tokens": tokens}
    step(params, batch_in)                                   # warm-up
    times, launches = [], []
    _reset_peak(dev)
    for _ in range(iters):
        ops.reset_launch_counts()
        nxt, s = _sync_s(lambda: step(params, batch_in), dev)
        launches.append(ops.launch_counts())
        times.append(s)
    peak = _peak(dev)
    med = statistics.median(times)
    out = {"batch": batch, "seq": seq, "times_s": times, "median_s": med,
           "tokens_per_s": batch * seq / med, "peak_bytes": peak,
           "launches": launches}
    k = last_logits(cfg, params, tokens)
    out["full"] = dict(compare(k, last_logits(cfg, params, tokens,
                                              impl="plain")),
                       step_agrees=bool(torch.equal(nxt[:, 0],
                                                    k.argmax(-1))))
    if profiled:
        out["profile"] = profile(lambda: step(params, batch_in))
        torch.cuda.empty_cache()
    return out


@torch.inference_mode()
def layer_check(cfg, params, tokens, *, groups=None) -> dict:
    """A forward over ``tokens`` on the kernel path in which every kernel
    call (``ops.flash_attention``, ``ops.ssd_scan``) is also run plain on
    the same inputs: each layer's kernel, on that layer's own inputs, held
    at every position by :func:`row_rel_err` (rows along the head width).
    The forward carries the kernel's output on, so no layer's difference
    carries into the next one's reading.  ``groups`` cuts the forward to
    the first groups."""
    readings = []

    def both(name, fn):
        def call(*args, impl=None, **kw):
            out = fn(*args, impl=impl, **kw)
            plain = fn(*args, impl="plain", **kw)
            if name == "ssd_scan":                  # (y, final state)
                readings.append(row_rel_err(out[0], plain[0]))
            else:
                readings.append(row_rel_err(out, plain))
            return out
        return call
    if groups is not None:
        params = dict(params, groups=lm.tree_map(lambda t: t[:groups],
                                                 params["groups"]))
    saved = {n: getattr(ops, n) for n in KERNELS}
    for n, fn in saved.items():
        setattr(ops, n, both(n, fn))
    try:
        lm.forward_hidden(cfg, params, tokens)
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)
    return {"per_layer": readings, "max": max(readings),
            "worst_layer": readings.index(max(readings))}


def f32_witness(cfg, *, batch: int, seq: int, device=None) -> dict:
    """The prefill's last-position logits with f32 weights (seed 0) and
    f32 activations, the same model as the bf16 runs with the bf16
    rounding taken away: ``kernel``, the kernel path against the plain
    path; ``nudged``, the plain path against itself with every embedding
    weight moved by ``NUDGE`` relative.  Where ``nudged`` is as far apart
    as ``kernel``, the depth amplifies any difference of rounding and the
    full-depth logits cannot tell a sound kernel from a faulty one."""
    saved = lm.ACT_DTYPE
    lm.ACT_DTYPE = torch.float32
    try:
        params = weights(cfg, device=device, dtype=torch.float32)
        dev = params["embed"].device
        tokens = prompt(cfg, batch, seq, dev)
        pl = last_logits(cfg, params, tokens, impl="plain")
        out = {"kernel": compare(last_logits(cfg, params, tokens), pl)}
        emb = params["embed"]
        noise = torch.randn(emb.shape, generator=torch.Generator(dev)
                            .manual_seed(3), device=dev)
        params["embed"] = emb * (1.0 + NUDGE * noise)
        del emb, noise
        out["nudged"] = compare(last_logits(cfg, params, tokens,
                                            impl="plain"), pl)
    finally:
        lm.ACT_DTYPE = saved
    return out


def profile(fn, top: int = 12) -> dict:
    """Device time by kernel of one call of ``fn`` (``torch.profiler``),
    with the shares of the port's kernels, of matrix products and of the
    rest."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    fn()
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    total = sum(by_name.values())

    def kind(name: str) -> str:
        low = name.lower()
        if any(k in name for k in flash_attention.KERNELS["flash"]):
            return "flash_attention"
        if any(k in name for k in ssd_scan.KERNELS["ssd"]):
            return "ssd_scan"
        if any(w in low for w in ("gemm", "xmma", "cutlass", "cublas",
                                  "nvjet")):
            return "matmul"
        return "other"
    shares: dict = {}
    for name, us in by_name.items():
        shares[kind(name)] = shares.get(kind(name), 0) + us
    return {"device_ms": total / 1e3,
            "share": {k: v / total for k, v in shares.items()} if total
            else {},
            "ms_by_kind": {k: v / 1e3 for k, v in shares.items()},
            "top": [[n[:120], us / 1e3] for n, us in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:top]]}


def requests(cfg, *, n: int = REQUESTS, max_new: int = MAX_NEW):
    rng = np.random.default_rng(2)
    lo, hi = PROMPT_LENS
    return [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, int(rng.integers(lo, hi + 1))).astype(np.int32),
        max_new_tokens=max_new) for i in range(n)]


def engine(cfg, params, *, slots: int = SLOTS, max_seq: int = MAX_SEQ,
           impl=None, n: int = REQUESTS, max_new: int = MAX_NEW) -> dict:
    """Run the requests through a fresh engine in waves of ``slots``."""
    reqs = requests(cfg, n=n, max_new=max_new)
    dev = params["embed"].device
    eng = ServeEngine(cfg, params, slots=slots, max_seq=max_seq,
                      device=dev, impl=impl)
    _reset_peak(dev)
    waves, outs = [], {}
    for w in range(0, len(reqs), slots):
        wave = reqs[w:w + slots]
        ops.reset_launch_counts()
        done, s = _sync_s(lambda: eng.run(wave), dev)
        launches = ops.launch_counts()
        prompt = sum(len(r.prompt) for r in wave)
        steps = max(len(r.prompt) for r in wave) + max_new
        waves.append({"requests": len(wave), "s": s, "steps": steps,
                      "prompt_tokens": prompt,
                      "new_tokens": sum(len(r.out) for r in done),
                      "launches": launches})
        outs.update({r.rid: list(r.out) for r in done})
    secs = sum(w["s"] for w in waves)
    new = sum(w["new_tokens"] for w in waves)
    return {"outs": outs, "waves": waves, "seconds": secs,
            "new_tokens_per_s": new / secs,
            "tokens_per_s": (new + sum(w["prompt_tokens"] for w in waves))
            / secs,
            "step_ms": secs / sum(w["steps"] for w in waves) * 1e3,
            "peak_bytes": _peak(dev),
            "lock_words_zero": bool((eng.slot_words == 0).all()),
            "fabric": eng.db.fabric_stats()}
