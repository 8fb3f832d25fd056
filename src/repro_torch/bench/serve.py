"""Model serving on the card: a prefill step and the dense engine.

The library behind ``chip_smoke.py`` phases ``serve`` and ``moe``.  For
one architecture at its full published config (``config(arch, layers)``
cuts the depth; ``reduced=True`` takes ``reduce_config``'s twin), with
bf16 weights drawn on the device from seed 0:

* :func:`prefill`: ``build_prefill_step`` on a (batch, seq) prompt of
  random tokens (with :func:`modality` features where the model takes
  them: the VLM's image, whisper's audio frames), one warm-up step, then
  ``iters`` timed steps (host clock around a synchronized step), each
  between a reset and a read of the kernel launch counts; the full-depth
  last-position logits of the kernel path against the plain path
  (``impl="plain"``); one profiled step.
* :func:`layer_check`: every layer's kernel against its plain version on
  that layer's own inputs in a kernel-path forward, at every position
  (self-attention, cross-attention and whisper's encoder layers), and
  every MoE layer's packed experts against the reference loop.
* :func:`mesh_layer_check` (under a sharding policy): every MoE layer's
  RRJ dispatch against its plain twin and against the one-shard packed
  experts, with its dropped assignments; :func:`forced_decode`:
  teacher-forced decode steps, their logits and launches.
* :func:`f32_witness`: the full-depth logits of both paths with f32
  weights and activations, and of the plain path against itself with its
  embedding nudged.
* :func:`decode`: greedy decode steps from ``init_decode_state(modality=)``
  (the cross caches filled from the features), timed, with their
  launches.
* :func:`engine`: ``ServeEngine(slots, max_seq)`` runs ``requests``
  requests (prompts of 16-64 tokens from a numpy seed, ``max_new`` new
  tokens each) in waves of ``slots``; launches are counted per wave.
* :func:`paged_engine`: the same requests, all enqueued at once, through
  ``ServeEngine(paged=True)`` (``max_resident`` of them in the two-tier
  block space, ``slots`` decoding a round); launches, CAS claims and
  seconds are taken per tick, and the seconds of each decode step apart
  from those of the swaps around it.
* :func:`count_on_device`, :func:`count_on_meta` (or, in a process of
  its own, :func:`start_count_on_meta`): the prefill step counted once
  by ``launch/roofline.py`` on the card and on meta tensors of the same
  shapes (what the card can count must agree, :func:`counts_agree`);
  :func:`roofline_row`: the row and the measured share.
* :func:`rrj_grad_check` (under a sharding policy): one MoE layer's RRJ
  gradients, kernel path against plain path and against the one-shard
  packed experts at the tokens that dropped nothing, with a
  dropped-expert control.
"""
from __future__ import annotations

import dataclasses
import statistics
import time

import numpy as np
import torch

from repro_torch._bits import resolve_device
from repro_torch.configs import ShapeCfg, get_config, reduce_config
from repro_torch.kernels import flash_attention, ops, radix_partition, \
    ssd_scan
from repro_torch.launch import roofline
from repro_torch.models import api, lm, moe
from repro_torch.serving import Request, ServeEngine
from repro_torch.sharding import set_policy
from repro_torch.train.train_step import build_prefill_step

# (batch, seq) of the prefill path per architecture
PREFILL = {"glm4-9b": (1, 8192), "mamba2-370m": (8, 8192),
           "llama4-maverick-400b-a17b": (1, 8192),
           "deepseek-v2-236b": (1, 8192),
           "jamba-1.5-large-398b": (1, 8192),
           "llama-3.2-vision-90b": (1, 8192),
           "whisper-base": (16, 448)}     # 16 utterances, 448 text tokens
SLOTS, MAX_SEQ, REQUESTS, MAX_NEW = 8, 1024, 16, 32
# the paged engine: 16 requests resident over 8 slots, 16-token blocks; a
# cold region of 128 blocks holds the requests' peak of 98 live blocks
# (JAX's fig_serve sizes its region the same way), so a 25 % hot tier is
# 32 blocks, below that peak
BLOCK_TOKENS, MAX_RESIDENT, CAPACITY_BLOCKS = 16, 16, 128
PROMPT_LENS = (16, 64)
KERNELS = ("flash_attention", "ssd_scan")     # the model path's kernels
NUDGE = 2.0 ** -20     # relative, about the kernel and plain paths' f32
                       # difference in one layer (the f32 flash sweep's
                       # error, 9.5e-7)


def config(arch: str, layers=None, *, reduced: bool = False):
    """The published config (``reduce_config``'s twin if ``reduced``), cut
    to ``layers`` layers if given."""
    cfg = get_config(arch)
    if reduced:
        cfg = reduce_config(cfg)
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


def modality(cfg, batch: int, device):
    """(batch, num_modality_tokens, modality_dim) f32 standard normal
    features from seed 4 (the stub front end's input), or None for a model
    that takes none."""
    if not cfg.modality_dim:
        return None
    g = torch.Generator(device).manual_seed(4)
    return torch.randn((batch, cfg.num_modality_tokens, cfg.modality_dim),
                       generator=g, device=device)


@torch.inference_mode()
def last_logits(cfg, params, tokens, *, modality=None,
                impl=None) -> torch.Tensor:
    """f32 logits of the last position (the prefill step's argmax input);
    the head runs on that position alone."""
    x, _ = api.module(cfg).forward_hidden(cfg, params, tokens,
                                          modality=modality, impl=impl)
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
    mod = modality(cfg, batch, dev)
    step = build_prefill_step(cfg)
    batch_in = {"tokens": tokens, "modality": mod}
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
    k = last_logits(cfg, params, tokens, modality=mod)
    out["full"] = dict(compare(k, last_logits(cfg, params, tokens,
                                              modality=mod, impl="plain")),
                       step_agrees=bool(torch.equal(nxt[:, 0],
                                                    k.argmax(-1))))
    if profiled:
        out["profile"] = profile(lambda: step(params, batch_in))
        torch.cuda.empty_cache()
    return out


@torch.inference_mode()
def layer_check(cfg, params, tokens, *, modality=None, groups=None) -> dict:
    """A forward over ``tokens`` (and ``modality``) on the kernel path in
    which every kernel call (``ops.flash_attention``, ``ops.ssd_scan``) is
    also run plain on the same inputs, and every MoE layer's packed
    experts (``moe._moe_packed``, which ranks on the kernel) also as the
    reference loop (``moe._moe_reference``): each layer, on its own
    inputs, held at every position by :func:`row_rel_err` (rows along the
    head or model width).  The forward carries the kernel path's output
    on, so no layer's difference carries into the next one's reading.
    ``groups`` cuts the forward to the first groups (of the encoder too).
    ``per_layer`` lists the readings in call order, ``kinds`` what each
    read: ``flash_attention`` a causal call, ``flash_noncausal`` a
    non-causal one (cross-attention, whisper's encoder), ``ssd_scan``,
    ``moe``."""
    readings, kinds = [], []

    def both(name, fn):
        def call(*args, impl=None, **kw):
            out = fn(*args, impl=impl, **kw)
            plain = fn(*args, impl="plain", **kw)
            if name == "ssd_scan":                  # (y, final state)
                readings.append(row_rel_err(out[0], plain[0]))
            else:
                readings.append(row_rel_err(out, plain))
            kinds.append("flash_noncausal" if name == "flash_attention"
                         and not kw.get("causal", True) else name)
            return out
        return call

    packed = moe._moe_packed

    def moe_both(cfg, mcfg, p, x, *, impl=None):
        out = packed(cfg, mcfg, p, x, impl=impl)
        readings.append(row_rel_err(out, moe._moe_reference(cfg, mcfg, p,
                                                            x)))
        kinds.append("moe")
        return out
    if groups is not None:
        params = dict(params, **{
            k: lm.tree_map(lambda t: t[:groups], params[k])
            for k in ("groups", "enc_groups") if k in params})
    saved = {n: getattr(ops, n) for n in KERNELS}
    for n, fn in saved.items():
        setattr(ops, n, both(n, fn))
    moe._moe_packed = moe_both
    try:
        api.module(cfg).forward_hidden(cfg, params, tokens,
                                       modality=modality)
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)
        moe._moe_packed = packed
    return {"per_layer": readings, "kinds": kinds, "max": max(readings),
            "worst_layer": readings.index(max(readings))}


def mesh_layer_check(cfg, params, tokens, *, faulty=None) -> dict:
    """Under a sharding policy (the caller's ``set_policy``): a kernel-path
    forward over ``tokens`` in which every MoE layer's RRJ dispatch
    (``moe._moe_rrj``, the rank and scatter kernels) is also run on the
    same inputs with the kernels' plain twins, and as today's one-shard
    packed experts (``moe._moe_packed``, no policy).  For each MoE layer:
    the dropped assignments of both runs (equal sets, their count and
    share), the kernel run against the plain run at every token
    (:func:`row_rel_err`), and against the packed experts at the tokens
    none of whose assignments dropped.  ``faulty(cfg, mcfg, p, x)``, a
    plain MoE layer with a fault, is read the same way on the first MoE
    layer (``control``): a sound check must read it far off."""
    rrj = moe._moe_rrj
    layers = []

    def check(cfg_, mcfg, p, x, *, impl=None, kept=False):
        y, k = rrj(cfg_, mcfg, p, x, impl=impl, kept=True)
        yp, kp = rrj(cfg_, mcfg, p, x, impl="plain", kept=True)
        clean = k.all(-1)                      # (B, S): nothing dropped
        with set_policy(None):
            packed = moe._moe_packed(cfg_, mcfg, p, x, impl=impl)
        rec = {"dropped": int((~k).sum()), "assignments": k.numel(),
               "dropped_plain": int((~kp).sum()),
               "drops_equal": bool(torch.equal(k, kp)),
               "vs_plain": row_rel_err(y, yp),
               "clean_tokens": int(clean.sum()),
               "vs_packed": row_rel_err(y[clean], packed[clean])}
        rec["dropped_share"] = rec["dropped"] / rec["assignments"]
        if faulty is not None and not layers:
            rec["control"] = row_rel_err(y[clean],
                                         faulty(cfg_, mcfg, p, x)[clean])
        layers.append(rec)
        return (y, k) if kept else y

    moe._moe_rrj = check
    try:
        with torch.inference_mode():
            api.module(cfg).forward_hidden(cfg, params, tokens)
    finally:
        moe._moe_rrj = rrj
    return {"per_layer": layers,
            "max_vs_plain": max(r["vs_plain"] for r in layers),
            "max_vs_packed": max(r["vs_packed"] for r in layers),
            "dropped": sum(r["dropped"] for r in layers),
            "assignments": sum(r["assignments"] for r in layers)}


@torch.inference_mode()
def forced_decode(cfg, params, tokens) -> dict:
    """Teacher-forced decode: ``tokens`` (B, steps) fed one position a step
    (``api.decode_step``) from a fresh state; each step's logits (B, V)
    and kernel launches."""
    batch, steps = tokens.shape
    state = api.init_decode_state(cfg, params, batch, steps)
    logits, launches = [], []
    for s in range(steps):
        ops.reset_launch_counts()
        out, state = api.decode_step(cfg, params, state, tokens[:, s:s + 1])
        launches.append(ops.launch_counts())
        logits.append(out[:, -1].float())
    return {"logits": logits, "launches": launches}


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
        mod = modality(cfg, batch, dev)
        pl = last_logits(cfg, params, tokens, modality=mod, impl="plain")
        out = {"kernel": compare(last_logits(cfg, params, tokens,
                                             modality=mod), pl)}
        emb = params["embed"]
        noise = torch.randn(emb.shape, generator=torch.Generator(dev)
                            .manual_seed(3), device=dev)
        params["embed"] = emb * (1.0 + NUDGE * noise)
        del emb, noise
        out["nudged"] = compare(last_logits(cfg, params, tokens,
                                            modality=mod, impl="plain"), pl)
    finally:
        lm.ACT_DTYPE = saved
    return out


@torch.inference_mode()
def decode(cfg, params, *, batch: int, steps: int = MAX_NEW) -> dict:
    """``steps`` greedy decode steps (``api.decode_step``, each token the
    argmax of the last) from ``init_decode_state(modality=)`` on a state
    of ``steps`` positions, the first token drawn as the prompt's.  The
    state's set-up (whisper's encoder and every cross cache) is timed
    apart; the steps' launches are counted between a reset and a read,
    and each step's logits must be finite."""
    dev = params["embed"].device
    mod = modality(cfg, batch, dev)
    state, init_s = _sync_s(lambda: api.init_decode_state(
        cfg, params, batch, steps, modality=mod), dev)
    tok = prompt(cfg, batch, 1, dev)
    ops.reset_launch_counts()
    step_s, finite = [], True
    for _ in range(steps):
        (logits, state), s = _sync_s(
            lambda: api.decode_step(cfg, params, state, tok), dev)
        finite = finite and bool(torch.isfinite(logits).all())
        tok = logits.argmax(-1)
        step_s.append(s)
    return {"batch": batch, "steps": steps, "init_s": init_s,
            "step_ms": {"median": statistics.median(step_s) * 1e3,
                        "max": max(step_s) * 1e3},
            "finite": finite, "launches": ops.launch_counts()}


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
        if any(k in name for k in radix_partition.KERNELS["rank"]):
            return "rank"
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


def paged_engine(cfg, params, *, slots: int = SLOTS, max_seq: int = MAX_SEQ,
                 block_tokens: int = BLOCK_TOKENS,
                 max_resident: int = MAX_RESIDENT,
                 capacity_blocks: int = CAPACITY_BLOCKS, impl=None,
                 n: int = REQUESTS, max_new: int = MAX_NEW, **kw) -> dict:
    """Enqueue the requests at once and tick a paged engine until all have
    finished.  ``kw`` goes to ``ServeEngine`` (``hot_frac``,
    ``hot_blocks``, ``prefetch``).  Each tick runs between a reset and a
    read of the launch counts, on the host clock with the device
    synchronized on both sides; its decode step is timed apart, after a
    synchronize that ends the swaps' device work, so a tick's seconds
    split into the step's and the rest (swap-out, swap-in, prefetch and
    the slot claim)."""
    reqs = requests(cfg, n=n, max_new=max_new)
    dev = params["embed"].device
    eng = ServeEngine(cfg, params, slots=slots, max_seq=max_seq, paged=True,
                      block_tokens=block_tokens, max_resident=max_resident,
                      capacity_blocks=capacity_blocks, device=dev, impl=impl,
                      **kw)
    step, step_s = eng._step, []

    def timed_step(tok):
        out, s = _sync_s(lambda: step(tok), dev)
        step_s.append(s)
        return out
    eng._step = timed_step
    for r in reqs:
        eng.enqueue(r)
    tp = eng.db.transport
    _reset_peak(dev)
    ticks, outs = [], {}
    while eng.resident or eng.waiting:
        claims = tp.stats().get("cas", {}).get("calls", 0)
        ops.reset_launch_counts()
        done, s = _sync_s(eng.tick, dev)
        ticks.append({"s": s, "step_s": step_s[-1],
                      "claimed": tp.stats().get("cas", {}).get(
                          "calls", 0) > claims,
                      "launches": ops.launch_counts()})
        outs.update({r.rid: list(r.out) for r in done})
    eng.quiesce()
    del eng._step            # the timer holds the engine: free it now
    secs = sum(t["s"] for t in ticks)
    step_secs = sum(t["step_s"] for t in ticks)
    new = sum(len(o) for o in outs.values())
    prompt = sum(len(r.prompt) for r in reqs)
    fab = eng.db.fabric_stats()
    tick_ms = [t["s"] * 1e3 for t in ticks]
    return {"outs": outs, "ticks": ticks, "seconds": secs,
            "tick_ms": {"median": statistics.median(tick_ms),
                        "max": max(tick_ms)},
            "tokens_per_s": (new + prompt) / secs,
            "new_tokens_per_s": new / secs,
            "swap_share": (secs - step_secs) / secs,
            "step_ms": {"median": statistics.median(
                [t["step_s"] * 1e3 for t in ticks])},
            "peak_bytes": _peak(dev),
            "lock_words_zero": bool((eng.slot_words == 0).all()),
            "store": eng.store.stats(),
            "hot_blocks": eng.store.hot_blocks,
            "block_bytes": eng.kv.block_words * 4,
            "cold": {v: {k: fab.get(v, {}).get(k, 0)
                         for k in ("calls", "msgs", "bytes")}
                     for v in ("read_cold", "write_cold")},
            "tiers": fab.get("tiers"),
            "fabric": fab}


# ------------------------------------------------------------- counting --

def _seen(count: roofline.StepCounter, live: bool) -> dict:
    """What the card can count of a step (``launch/roofline.py``): the
    kernelized totals, the collectives, the regions; the peak live bytes
    only without a mesh (the card's shards run in turns, all alive at
    once, where a meta mesh runs one body for all); and, to show where
    two counts differ, the kernelized bytes by op outside the shard
    bodies and in shard 0's."""
    t = count.totals()
    out = {"flops_k": t["flops_k"], "bytes_k": t["bytes_k"],
           "collectives": t["collectives"], "regions": t["regions"]}
    if live:
        out["peak_live_k"] = count.peak_live_k
    out["by_op"] = {f"{scope}:{k}": v for scope in (None, 0)
                    if scope in count.tallies
                    for k, v in count.tallies[scope].bytes_by_op.items()
                    if v}
    return out


def count_on_device(cfg, params, *, batch: int, seq: int, mesh=None) -> dict:
    """The prefill step on (batch, seq) prompt tokens counted once on the
    parameters' device (under ``make_policy(mesh)`` when given).  On the
    card the kernels are regions that credit themselves."""
    from repro_torch.sharding import make_policy
    step = build_prefill_step(cfg)
    dev = params["embed"].device
    b = {"tokens": prompt(cfg, batch, seq, dev),
         "modality": modality(cfg, batch, dev)}
    t0 = time.perf_counter()
    with set_policy(None if mesh is None else make_policy(mesh)), \
            roofline.StepCounter() as c:
        step(params, b)
    return {"seen": _seen(c, mesh is None),
            "per_shard": {i: c.tallies[i].collectives for i in c.shards},
            "seconds": time.perf_counter() - t0}


def count_on_meta(cfg, *, batch: int, seq: int, mesh_shape=None) -> dict:
    """The same step counted by the dry-run (``dryrun.count_cell``: bf16
    parameters from ``api.param_shapes`` on meta tensors, int64 tokens as
    the card's prompts), under the meta twin of a (data, model) mesh of
    ``mesh_shape`` when given: what the card can count, the step's
    argument bytes per device, and ``roofline.analyze``'s row (its
    JAX-comparable totals hold the plain ops inside the kernel regions,
    which the card does not see)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    mesh = None if mesh_shape is None else make_host_mesh(*mesh_shape,
                                                          device="meta")
    shape = ShapeCfg("measured", seq, batch, "prefill")
    c, nbytes, secs = dryrun.count_cell(cfg, shape, mesh,
                                        tokens_dtype=torch.int64)
    n = 1 if mesh is None else mesh.size
    return {"seen": _seen(c, mesh is None), "argument_bytes": nbytes,
            "row": roofline.analyze(cfg, shape, c, n), "n_chips": n,
            "seconds": secs}


def _count_on_meta_into(queue, cfg, kw):
    queue.put(count_on_meta(cfg, **kw))


def start_count_on_meta(cfg, **kw):
    """:func:`count_on_meta` in a process of its own (spawned: it starts
    no CUDA context), so that the CPU work runs beside the card's; read it
    with :func:`join_count_on_meta`."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=_count_on_meta_into, args=(queue, cfg, kw),
                       daemon=True)
    proc.start()
    return proc, queue


def join_count_on_meta(handle, timeout: float = 900.0) -> dict:
    proc, queue = handle
    try:
        return queue.get(timeout=timeout)
    finally:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.kill()
            proc.join()


def counts_agree(device: dict, meta: dict) -> tuple:
    """(equal, the device's view, the meta device's) of what the card can
    count; the views keep their bytes by op only where they differ."""
    a, b = dict(device["seen"]), dict(meta["seen"])
    da, db = a.pop("by_op"), b.pop("by_op")
    equal = a == b
    if not equal:
        keys = {k for k in set(da) | set(db) if da.get(k) != db.get(k)}
        a["by_op"] = {k: da.get(k, 0) for k in keys}
        b["by_op"] = {k: db.get(k, 0) for k in keys}
    return equal, a, b


def roofline_row(meta: dict, *, median_s: float) -> dict:
    """The meta count's roofline row with the measured median step and
    ``mfu``: MODEL_FLOPS over the bf16 peak over that median."""
    from repro_torch.core.costmodel import H100
    row = dict(meta["row"])
    mf = row["model_flops_per_chip"] * meta["n_chips"]
    row.update(model_flops=mf, median_s=median_s,
               mfu=mf / H100.peak_flops_bf16 / median_s,
               kernelized_bound_over_median=row["bound_s_kernelized"]
               / median_s)
    return row


def packed_expert_dropped(cfg, mcfg, p, x):
    """``moe._moe_packed`` with one expert's weights zeroed (the first
    choice of the first token, so it has work): a dispatch that lost an
    expert's rows, whose gradients for that expert are zero."""
    _, idx, _ = moe._gates(mcfg, x.reshape(-1, x.shape[-1])[:1],
                           p["router"])
    e = int(idx[0, 0])
    q = dict(p, wi=[w * 0 if i == e else w for i, w in enumerate(p["wi"])])
    return moe._moe_packed(cfg, mcfg, q, x)


def rrj_grad_check(cfg, layer, x, g, *, tol: float) -> dict:
    """One MoE layer's RRJ gradients under the caller's policy (its mesh
    on the card): the gradients of x, the router, wi and wo, with the
    output gradient ``g`` zeroed at the tokens any of whose assignments
    dropped, through the kernels and through their plain twins (equal to
    the bit), and against the one-shard packed experts (autograd, no
    policy) within ``tol`` a leaf (the norm of the difference over the
    packed gradient's); :func:`packed_expert_dropped`, a packed layer
    with an expert dropped, must read above ``tol``.  The backward's
    kernel launches are counted on their own."""
    mcfg = cfg.moe
    p = {k: layer[k] for k in ("router", "wi", "wo")}
    with torch.no_grad():
        _, kept = moe._moe_rrj(cfg, mcfg, p, x, kept=True)
    clean = kept.all(-1)
    gm = torch.where(clean[..., None], g, torch.zeros_like(g))
    names = ("x", "router", "wi", "wo")

    def rrj(impl):
        leaves = [t.detach().requires_grad_(True) for t in (x, *p.values())]
        y = moe._moe_rrj(cfg, mcfg, dict(zip(p, leaves[1:])), leaves[0],
                         impl=impl)
        ops.reset_launch_counts()
        grads = torch.autograd.grad(y, leaves, gm)
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        return dict(zip(names, grads)), launches

    def packed(fn):
        """Autograd of a one-shard layer, the experts as one leaf each
        (a slice of one stacked leaf would write a full-size gradient per
        expert)."""
        xs = x.detach().requires_grad_(True)
        r = p["router"].detach().requires_grad_(True)
        wi = [t.detach().requires_grad_(True) for t in p["wi"].unbind(0)]
        wo = [t.detach().requires_grad_(True) for t in p["wo"].unbind(0)]
        with set_policy(None):
            y = fn(cfg, mcfg, {"router": r, "wi": wi, "wo": wo}, xs)
        leaves = [xs, r, *wi, *wo]
        grads = torch.autograd.grad(y, leaves, gm, allow_unused=True)
        # an expert no token reached is unused: its gradient is zero
        gx, gr, *gw = (torch.zeros_like(t) if d is None else d
                       for t, d in zip(leaves, grads))
        E = len(wi)
        return {"x": gx, "router": gr, "wi": torch.stack(gw[:E]),
                "wo": torch.stack(gw[E:])}

    def rel(a, b):
        return {k: float((a[k].float() - b[k].float()).norm()
                         / b[k].float().norm().clamp_min(1e-30))
                for k in names}

    kern, launches = rrj(None)
    plain, _ = rrj("plain")
    equal = {k: bool(torch.equal(kern[k], plain[k])) for k in names}
    del plain
    want = packed(lambda c, m, q, xs: moe._moe_packed(c, m, q, xs))
    out = {"tokens": int(clean.numel()), "clean_tokens": int(clean.sum()),
           "dropped": int((~kept).sum()), "assignments": kept.numel(),
           "kernel_equals_plain": equal, "vs_packed": rel(kern, want),
           "held_to": tol, "backward_launches": launches}
    del want
    out["control"] = rel(kern, packed(packed_expert_dropped))
    return out
