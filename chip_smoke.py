#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

  env      torch / CUDA / nvcc / triton versions, the card and its power
           limit
  build    nvcc builds every kernel source in src/repro_torch/kernels/csrc
           for sm_90a, one process per source, all at once; the flash
           library's SASS must hold HGMMA and UTMALDG (the bf16 body's
           wgmma and TMA loads)
  kernels  each hand-written kernel held against its plain PyTorch
           version over a sweep of shapes (bit-exact; the scatter with the
           rank's counts, at row widths of every body: narrow, medium,
           wide; grouped_agg's entries on both sides of every boundary of
           grouped_agg.plan and at 2^26 and 2^28 slots, with skewed cases,
           and its keys entry in RDMA-AGG's layouts; the f32 grouped_agg
           within atol 1e-3, rtol 1e-4 on random floats; flash_attention
           within 2e-5 in f32 and 2e-2 in bf16, and in bf16 each query
           row's rms difference within ROW_TOL of its rms, at S up to 4096
           and at glm4's S = 8192, where a control with one key tile
           dropped must read above ROW_TOL; ssd_scan within 2e-3 in f32
           and, in bf16, y within 2e-2 and the f32 state within 2e-3, over
           SSD_SWEEP and at mamba2's layer), radix_partition also at the
           joins' A = 128 000 000 and its rank alone at 2^24 requests into
           8 and 64 buckets, then each timed at the
           main paths' shapes (per call between CUDA events, and its device
           time from torch.profiler) beside its plain version, the nearest
           single PyTorch call and its bound (the larger of bytes / 3.35
           TB/s and operations / 989 TFLOP/s; flash also its TFLOP/s
           and share of the bound); for cas, the scatter, the rank and
           grouped_agg (at every table size of the OLAP path) also the
           host time to issue a call (and the PyTorch call's where there
           is one), the rank its scan's own device time, and a cas call
           must be one device operation, with no fill
  oltp     the OLTP path at the paper's §4.3 width: Database(device="cuda")
           with 1 000 000 products of 1 KB (+131 072 insert rows), 8 waves
           of 4096 checkout sessions (Session.begin/get/put ->
           Database.commit, max_retries=2), held against the same waves on
           a second Database whose kernels run their plain versions
  olap     the OLAP path at the paper's §5.4 size (configs OLAP: 128 000 000
           tuples a relation): Fig 8a's four joins over four bloom
           selectivities and Fig 8b's two aggregation schemes over the
           distinct-group sweep up to 67 108 864, through
           Database.load_table / scan / explain / execute, each held to
           its independent ground truth and to a second Database whose
           kernels run their plain versions; times, peak memory, and one
           profiled execution per variant at sel 0.5, G = 64 and 2**26.
           Then, outside those queries: Fig 8b's kernel row (a direct
           ops.grouped_agg call, f32, 2048 slots) and the shuffle
           microbench's two legs (direct LocalTransport.route calls)
  fig6     the fig6 commit batch at the JAX benchmark's sizes and at the
           paper's width (T = 1024, 8192), txn/s from the median of 40
           commits between CUDA events, and their spread
  serve    model serving at full published width and depth
           (src/repro_torch/bench/serve.py): glm4-9b and mamba2-370m with
           bf16 weights drawn on the card; the prefill step (glm4 B=1,
           mamba2 B=8, S=8192; median of 3 after a warm-up) must launch
           flash_attention / ssd_scan once a layer; every layer's kernel is
           held to its plain version on that layer's inputs at every
           position (within ROW_TOL, a faulty plain version reading above
           it), and the full-depth logits with f32 weights within
           F32_LOGIT_TOL wherever a 2^-20 nudge of the embedding moves the
           plain path's less (the bf16 full-depth difference is
           reported); then ServeEngine(slots=8,
           max_seq=1024) serves 16 requests in two waves, each wave must
           launch cas_lock, and its tokens must equal a plain engine's
  shards   the n-shard fabric (MeshTransport(4) on the one card: a host
           thread a shard, collectives at a barrier): the radix and CAS
           kernels at the shards' shapes against their plain versions;
           the oltp checkout at the same width on 4 shards
           (max_retries=0), whose masks, store and txn_stats must equal a
           one-shard run's and a plain 4-shard run's (fabric_stats too),
           every committed write reading back, and whose rank, scatter
           and cas launches must be exactly 4x the one-shard run's; the
           fig6 paper_T8192 commit on 4 shards beside 1 (median of 40,
           host time to issue, profiled device time); the four joins at
           sel 0.5 and both aggregations at G in {64, 2^20, 2^26} on 4
           shards of 32 000 000 tuples, each equal to its ground truth
           and to the same query on one shard (RRJ also to the plain
           path), with times and peak memory
  train    the rank and the scatter at a parameter-server push's shapes
           (4 rows of 23.4 M and of 92 M lanes) against their plain
           versions, timed; the trainer (src/repro_torch/bench/train.py)
           at mamba2-370m's full config, f32 masters from seed 0, AdamW, SyntheticLM
           batches of 8 x 2048, through Trainer.run in three sync modes:
           allreduce (6 steps), raw paramserver(staleness=0) (6 steps,
           losses equal to allreduce's within PARITY_RTOL) and compressed
           paramserver(staleness=4) (8 steps, epoch 8, every push routing
           bench.train.route_bytes); seconds a step, tokens/s, pull and
           push ms, peak memory and one more step, profiled, split by
           where its device time goes; then, on the first batch, every
           layer's bf16 kernel against its plain version at the training
           shapes within ROW_TOL, and the gradients on the kernel path
           against the plain path, leaf by leaf, in f32 within GRAD_TOL
           (a faulty plain path above both limits) and in bf16 within
           each leaf's spread of bf16 rounding, for mamba2-370m and
           for glm4-9b at full width cut to 2 layers (B 1, S 4096: one
           build_grad_step, which must launch flash_attention twice a
           layer); and Fig 9
           (bench/fig9_ml.py) at the reference's sizes, its rows equal to
           a CPU run's, with one PS round timed

  scale    fig_scale (bench/fig_scale.py): at the JAX benchmark's sizes
           (4096 records, W in 1..64, uniform / zipf 0.9 / zipf 1.2) the
           kernel path against the plain path (txn_stats, attempts, ids,
           masks, store leaves equal) and the three panels' asserts; at
           the oltp store (1 000 000 records of 1 KB, 64 transactions a
           worker, T = 4096 at W = 64, max_retries 3) each point's
           grouped wave: launches, read-back, commits + final aborts ==
           sessions, host seconds, device time profiled; at W = 64 zipf
           1.2 the store equal to the plain path's; panels (b) and (c) on
           those traces, with the simulator's host time
  contention  Fig 10 (bench/fig10_contention.py): the window sweep; the
           planner's load crossover on the §5.4 join (R and S of 128M
           tuples, sel 0.25) at loads 0, 8, 64; one GHJ and one RRJ at
           128M recorded through an EventTracer on the kernel and the
           plain path (traces equal event for event, values equal to the
           ground truth) and replayed on every profile; fig8a's replay
           row; then fabric-check on the card: every suite (0
           violations) and one 4096-session checkout wave through a
           ScheduleRecorder, race-checked (0 violations)

The kernels' f32 entries (flash_f32, ssd_kernel), which no timed path
runs, are timed in phase kernels at the f32 witnesses' shapes, and their
launches are counted where serve's f32 witness and train's f32 gradient
check run them (a comparison's launches, on no path): one f32_entries
line.

Launch counts are set to 0 just before each path and read just after:
the oltp sessions and commits, the olap queries (Database.execute
alone), Fig 8b's kernel row, the one path of the f32 grouped_agg
entry, in serve each timed prefill step and each engine wave, in
shards the 4-shard oltp waves and the 4-shard queries, and in train
each trainer run, Fig 9 and glm4's grad step, in scale every grouped
wave, in contention each traced join and the recorded wave; each path
must have launched every kernel it runs.  The gradient checks' launches
count on no path.  The shuffle microbench's launches are reported beside
it and counted on no path.
Then three lines: the per-kernel JSON record (launches summed over the
paths named in its "paths"), the card's name and power limit
(nvidia-smi), and {"ok": true, "device": ...}.

    python3 chip_smoke.py            # everything, one card
    python3 chip_smoke.py --phases env,build,kernels --quick
    python3 chip_smoke.py --out smoke.jsonl   # also keep every phase line
    python3 chip_smoke.py --phases env,build,shards   # the n-shard fabric
    python3 chip_smoke.py --phases env,build,train    # training
    python3 chip_smoke.py --phases env,build,scale,contention   # under load
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 peak
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor cores
F32_FLOP_PER_S = 67e12             # H100 SXM float32 outside tensor cores
PHASES = ("env", "build", "kernels", "oltp", "olap", "fig6", "serve",
          "shards", "train", "scale", "contention")
SERVE_ARCHS = {"glm4-9b": "flash_attention", "mamba2-370m": "ssd_scan"}
ROW_TOL = 2 ** -6        # bf16, kernel vs plain: rms(diff) / rms(plain)
                         # per row (a query row of one head; an SSD output
                         # row of one head), the worst row
F32_LOGIT_TOL = 0.05     # f32 weights and activations, full depth: last-
                         # position logits, kernel path vs plain path
MAIN_T, MAIN_WAVES = 4096, 8     # checkouts per wave, waves (the store's
                                 # widths: configs/paper_nam.py::OLTP)
FIG6_ITERS = 40                  # timed commits per fig6 run
OLAP_N = 128_000_000             # tuples a relation: configs OLAP
OLAP_QUICK_N = 1 << 22
RANK_WIDE_A = 1 << 24            # check_radix's rank-only cases: 4096 blocks
PROFILE_SELS = (0.5,)            # one profiled execution per join here
PROFILE_GROUPS = (64, 67_108_864)  # ... and per aggregation scheme here
OLTP_KERNELS = ("radix_partition_rank", "radix_partition_scatter",
                "cas_lock")
OLAP_KERNELS = ("radix_partition_rank", "radix_partition_scatter",
                "grouped_sum_u32")
KERNEL_ROW_KERNELS = ("grouped_agg",)
SHARDS = 4                       # the paper's 3 storage and 4 client nodes
                                 # as one n
SHARD_GROUPS = (64, 1 << 20, 1 << 26)
TRAIN_ARCH = "mamba2-370m"
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
TRAIN_MODES = (("allreduce", True, 6),          # (sync mode, compressed
               ("paramserver(staleness=0)", False, 6),   # push, steps)
               ("paramserver(staleness=4)", True, 8))
PARITY_RTOL = 1e-4       # allreduce vs raw paramserver(staleness=0) losses
GRAD_TOL = 2 ** -8       # kernel vs plain path gradients, f32 masters and
                         # f32 activations: rms(diff) / rms(plain) per
                         # leaf, the worst leaf (on an H100: sound 2.4e-5
                         # and 2.3e-4, faulty controls 0.034 and 0.90, for
                         # mamba2-370m and glm4-9b)
GLM_GRAD = ("glm4-9b", 2, 1, 4096)   # arch, layers, batch, seq
SCALE_TXNS = 64          # fig_scale at the oltp store: transactions a
                         # worker, so T = 4096 at W = 64 (the oltp wave)
SCALE_QUICK = (65_536, 16, 16)   # --quick: records, payload words, txns
CONTENTION_VARIANTS = ("ghj", "rrj")
JOIN_KERNELS = ("radix_partition_rank", "radix_partition_scatter")
F32 = {"flash_f32": {}, "ssd_kernel": {}}   # the kernels' f32 entries:
                         # timed in phase kernels, launches counted where
                         # the f32 witnesses and gradient checks run them
_OUT = []                        # a file every emitted line also goes to


def emit(phase: str, **kw):
    line = json.dumps({"phase": phase, **kw})
    print(line, flush=True)
    for f in _OUT:
        f.write(line + "\n")
        f.flush()


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ------------------------------------------------------------- timing ---

def time_ms(fn, *, setup=None, iters=20, warmup=3):
    """Median milliseconds of ``fn()`` over ``iters`` calls, each between
    its own CUDA events; ``setup()`` runs before each call, outside the
    window (it restores state an in-place kernel changed)."""
    import torch
    out = []
    for k in range(warmup + iters):
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        if k >= warmup:
            out.append(a.elapsed_time(b))
    return statistics.median(out)


def device_ms(fn, kernels, *, setup=None, iters=20) -> float:
    """Mean device milliseconds per call of ``fn()`` spent in the named
    kernels and in fills (``torch.profiler``): the kernel's own time,
    without the host work of its wrapper.  ``setup()`` runs before each
    call; its copies are not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if setup is not None:
                setup()
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and (e.name.startswith("Memset")
                  or any(f"::{k}{c}" in e.name for k in kernels
                         for c in "(<")))
    if us == 0:
        raise AssertionError(f"the profiler saw none of {kernels}")
    return us / 1e3 / iters


def host_ms(fn, *, setup=None, iters=50, warmup=5) -> float:
    """Median host milliseconds to issue ``fn()``: ``time.perf_counter``
    around the call alone, with no sync inside, the device idle before it
    (a sync after ``setup()``, outside the window)."""
    import torch
    out = []
    for k in range(warmup + iters):
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        if k >= warmup:
            out.append((t1 - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(out)


def device_ops(fn, *, iters=10) -> dict:
    """Device operations (kernels, copies, fills) per call of ``fn()`` by
    name, from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    names: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names[e.name] = names.get(e.name, 0) + 1
    return {k: v / iters for k, v in names.items()}


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def launches_since(before: dict) -> dict:
    """Kernel launches since ``before`` (an ``ops.launch_counts()``), for
    a comparison that counts on no path and must not reset the counts."""
    from repro_torch.kernels import ops
    return {k: v - before[k] for k, v in ops.launch_counts().items()}


def _count_f32(entry: str, wrapper: str, before: dict):
    """Add the launches of an f32 witness or gradient check (every launch
    of ``wrapper`` since ``before`` is its f32 entry) to F32."""
    n = launches_since(before)[wrapper]
    F32[entry]["launches"] = F32[entry].get("launches", 0) + n


# -------------------------------------------------------------- phases ---

def phase_env():
    import torch
    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = None
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc, triton=triton_v, python=sys.version.split()[0],
         gpu=smi(), device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())


def _nvcc():
    from repro_torch.kernels import build
    return build.nvcc()


def sass_counts(name: str, ops=("HGMMA", "UTMALDG")) -> dict:
    """How often each instruction occurs in a built library's SASS
    (``cuobjdump -sass``)."""
    from repro_torch.kernels import build
    cuobjdump = str(Path(build.nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ops}


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build()
    secs = time.perf_counter() - t0
    # ptxas -v: registers / shared memory / spills per kernel, and what it
    # says of setmaxnreg and wgmma
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if any(w in ln for w in ("registers", "spill",
                                             "setmaxnreg", "wgmma"))]
             for name, log in report.items()}
    # the bf16 flash body is wgmma fed by TMA, or the build fails
    flash_sass = sass_counts("flash_attention")
    emit("build", seconds=secs, sources=list(report), ptxas=ptxas,
         flash_sass=flash_sass, dir=str(build.BUILD_DIR.relative_to(ROOT)))
    if not all(flash_sass.values()):
        raise AssertionError(f"flash_attention's SASS lacks an instruction "
                             f"of its design: {flash_sass}")


def _rand_dest(g, A, n, dev):
    import torch
    # mostly deliverable, some filtered on both sides
    return torch.randint(-2, n + 2, (A,), generator=g, device=dev,
                         dtype=torch.int32)


def check_radix(quick: bool, stats: dict):
    """rank + scatter bit-exact against ref over the sweep, then the rank
    alone at RANK_WIDE_A requests into 8 and 64 buckets."""
    import torch
    from repro_torch.kernels import radix_partition as rp, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    sizes = (1, 1000) if quick else (1, 1000, 1 << 20)
    cases = 0
    for A in sizes:
        for w in (1, 5, 261) + ((2000, 5003) if A <= 1000 else ()):
            rows = torch.randint(-2 ** 31, 2 ** 31 - 1, (A, w), generator=g,
                                 device=dev, dtype=torch.int32)
            mask = torch.rand((A,), generator=g, device=dev) < 0.7
            for n in (1, 8, 64):
                dest = _rand_dest(g, A, n, dev)
                inb = dest[(dest >= 0) & (dest < n)].to(torch.int64)
                most = int(torch.bincount(inb, minlength=n).max()) if \
                    inb.numel() else 0
                for cap in sorted({max(most, 1), max(most // 2, 1)}):
                    got = rp.rank(dest, n, cap)
                    want = ref.rank(dest, n, cap)
                    for x, y, what in zip(got, want, ("slot", "keep",
                                                      "overflow", "counts")):
                        if not torch.equal(x, y):
                            raise AssertionError(
                                f"radix rank {what} differs: A={A} n={n} "
                                f"cap={cap}")
                    stats["rank"] = max(stats["rank"], _err(got[0], want[0]))
                    for m in (None, mask):
                        kb = rp.scatter(rows, got[0], n * cap,
                                        counts=got[3], mask=m)
                        pb = ref.scatter(rows, got[0], n * cap,
                                         counts=got[3], mask=m)
                        if not torch.equal(kb, pb):
                            raise AssertionError(
                                f"radix scatter differs: A={A} n={n} "
                                f"cap={cap} w={w} mask={m is not None}")
                        stats["scatter"] = max(stats["scatter"], _err(kb, pb))
                        cases += 1
                    del kb, pb
            del rows
            torch.cuda.empty_cache()
    # the rank alone at RANK_WIDE_A requests: more blocks than the scan
    # over blocks has threads, in every bucket's column
    for n in (8, 64):
        dest = _rand_dest(g, RANK_WIDE_A, n, dev)
        inb = dest[(dest >= 0) & (dest < n)].to(torch.int64)
        most = int(torch.bincount(inb, minlength=n).max())
        for cap in (most, most // 2):
            got = rp.rank(dest, n, cap)
            want = ref.rank(dest, n, cap)
            for x, y, what in zip(got, want, ("slot", "keep", "overflow",
                                              "counts")):
                if not torch.equal(x, y):
                    raise AssertionError(
                        f"radix rank {what} differs: A={RANK_WIDE_A} n={n} "
                        f"cap={cap}")
            stats["rank"] = max(stats["rank"], _err(got[0], want[0]))
            cases += 1
        del dest, inb, got, want
    torch.cuda.empty_cache()
    return cases


def _err(a, b) -> int:
    import torch
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def check_cas(quick: bool, stats: dict):
    """cas bit-exact against ref.cas (heavy conflicts, mixed and negative
    priorities, idx < 0 and >= R) and, in the cas_lock case, against the
    sequential FIFO ref.cas_lock."""
    import torch
    from repro_torch._bits import LOCK_BIT
    from repro_torch.kernels import cas_lock as ck, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    cases = 0
    for R in (1, 1000, 1_131_072):
        for A in ((1, 1000) if quick else (1, 1000, 1 << 20)):
            span = min(R, 64) + 4            # heavy conflicts near 0..span
            idx = torch.randint(-2, span, (A,), generator=g, device=dev,
                                dtype=torch.int32)
            spread = torch.randint(-2, R + 3, (A,), generator=g, device=dev,
                                   dtype=torch.int32)
            idx = torch.where(torch.rand((A,), generator=g, device=dev)
                              < 0.5, idx, spread)
            words = torch.randint(0, 4, (R,), generator=g, device=dev,
                                  dtype=torch.int32)
            exp = torch.where(
                torch.rand((A,), generator=g, device=dev) < 0.7,
                words[idx.clamp(0, R - 1).to(torch.int64)],
                torch.randint(0, 4, (A,), generator=g, device=dev,
                              dtype=torch.int32))
            new = torch.randint(-2 ** 31, 2 ** 31 - 1, (A,), generator=g,
                                device=dev, dtype=torch.int32)
            for prio in (
                    torch.randint(-3, 3, (A,), generator=g, device=dev,
                                  dtype=torch.int32),
                    torch.randint(-2 ** 31, 2 ** 31 - 1, (A,), generator=g,
                                  device=dev, dtype=torch.int32),
                    torch.arange(A, dtype=torch.int32, device=dev)):
                kw, pw = words.clone(), words.clone()
                ok_k = ck.cas(kw, idx, exp, new, prio)
                ok_p = ref.cas(pw, idx, exp, new, prio)
                if not (torch.equal(ok_k, ok_p) and torch.equal(kw, pw)):
                    raise AssertionError(f"cas differs: R={R} A={A}")
                stats["cas"] = max(stats["cas"], _err(kw, pw))
                cases += 1
            if A <= 1000 or not quick:
                # the cas_lock case: unlocked expected words, FIFO order.
                # idx == R is moved past it: there the verb's clamped
                # compare lets a request win the spare slot, where the
                # FIFO fails it (every other index agrees)
                lidx = torch.where(idx == R, R + 1, idx)
                lk = words.clone()
                ok_k = ck.cas(lk, lidx, exp, exp | LOCK_BIT,
                              torch.arange(A, dtype=torch.int32, device=dev))
                ok_f, fw = ref.cas_lock(words, lidx, exp)
                if not (torch.equal(ok_k, ok_f) and torch.equal(lk, fw)):
                    raise AssertionError(f"cas_lock case differs: R={R} "
                                         f"A={A}")
                cases += 1
    best, slot_r = ck.arbitration_scratch(1, dev)
    if best.numel() < 1_131_072:
        raise AssertionError("cas's arbitration table is not the one the "
                             "sweep used")
    if not (bool((best == -1).all()) and int(slot_r[0]) == -1):
        raise AssertionError("cas left its arbitration scratch dirty")
    return cases


def grouped_sweep(rows: int) -> tuple:
    """check_grouped's table sizes: small tables, both sides of every
    boundary of grouped_agg.plan at ``rows`` rows, and RDMA-AGG's tables
    at Fig 8b's largest G (2**26 groups, 4 chunks: 2**28 slots)."""
    from repro_torch.kernels import grouped_agg as ga
    edges = {S + k for S in ga.boundaries(rows, ga.device_info("cuda"))
             for k in (0, 1)}
    return tuple(sorted({1, 64, 2048, 4096, 1 << 26, 1 << 28} | edges))


def check_grouped(quick: bool, stats: dict):
    """grouped_sum_u32 bit-exact against ref over random u32 words (sums
    wrap), grouped_agg (f32) bit-exact on small signed integers and within
    atol 1e-3, rtol 1e-4 on uniform [0, 1) floats (the f32 atomics add in
    an order that changes from run to run), over N up to 2**27 and S over
    grouped_sweep (every path of the plan, up to 2**28 slots); uniform
    slots, and 90 % of the rows in one slot at 2048 and 2**26 slots.  The
    keys entry bit-exact against its plain version on keys with the top
    bit set in half the rows: key % G, and RDMA-AGG's phase-1 layouts
    (4 chunks, 1 and 4 owners).  Then all three on views one int past an
    allocation (no 16-byte loads) and on an odd row count, with chunks of
    an odd number of rows."""
    import torch
    from repro_torch.kernels import grouped_agg as ga, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    sizes = (1, 1000, 1 << 20) if quick else (1, 1000, 1 << 20, 1 << 27)
    cases = 0
    for N in sizes:
        words = torch.randint(-2 ** 31, 2 ** 31 - 1, (N,), generator=g,
                              device=dev, dtype=torch.int32)
        ints = torch.randint(-8, 9, (N,), generator=g, device=dev
                             ).to(torch.float32)
        floats = torch.rand((N,), generator=g, device=dev)
        keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (N,), generator=g,
                             device=dev, dtype=torch.int32)
        for S in grouped_sweep(N):
            uni = torch.randint(0, S, (N,), generator=g, device=dev,
                                dtype=torch.int32)
            layouts = [("uniform", uni)]
            if S in (2048, 1 << 26):
                layouts.append(("skewed", torch.where(
                    torch.rand((N,), generator=g, device=dev) < 0.9, S // 2,
                    uni)))
            for skew, slot in layouts:
                where = f"N={N} S={S} {skew} ({ga.plan(S, N).path})"
                got = ga.grouped_sum_u32(slot, words, S)
                if not torch.equal(got, ref.grouped_sum_u32(slot, words, S)):
                    raise AssertionError(f"grouped_sum_u32 differs: {where}")
                got = ga.grouped_agg(slot, ints, S)
                if not torch.equal(got, ref.grouped_agg(slot, ints, S)):
                    raise AssertionError(f"grouped_agg (integers) differs: "
                                         f"{where}")
                got = ga.grouped_agg(slot, floats, S)
                want = ref.grouped_agg(slot, floats, S)
                if not torch.allclose(got, want, atol=1e-3, rtol=1e-4):
                    raise AssertionError(f"grouped_agg (floats) outside "
                                         f"atol 1e-3 rtol 1e-4: {where}")
                stats["grouped_agg"] = max(stats["grouped_agg"], float(
                    (got - want).abs().max()))
                cases += 3
            del uni, layouts
            for chunks, owners in ((1, 1), (4, 1), (4, 4)):
                if chunks * S > 1 << 28 or N % chunks:
                    continue
                got = ga.grouped_sum_u32_by_key(keys, words, S, chunks=chunks,
                                                n=owners)
                want = ref.grouped_sum_u32_by_key(keys, words, S,
                                                  chunks=chunks, n=owners)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"grouped_sum_u32_by_key differs: N={N} G={S} "
                        f"chunks={chunks} n={owners}")
                cases += 1
            torch.cuda.empty_cache()
        del words, ints, floats, keys
        torch.cuda.empty_cache()
    # views one int past an allocation (no 16-byte loads), a row count
    # that is no multiple of 4, and chunk boundaries inside a quad of rows
    base = torch.randint(-2 ** 31, 2 ** 31 - 1, (3, 4 * 250_001 + 1),
                         generator=g, device=dev, dtype=torch.int32)
    keys, words = base[0, 1:], base[1, 1:]
    floats = torch.rand((base.shape[1],), generator=g, device=dev)[1:]
    for S in (64, 2048, 51_201, 1 << 22, (1 << 22) + 1, 1 << 26):
        for N, view in ((keys.shape[0], True), (keys.shape[0] - 1, True),
                        (keys.shape[0] - 1, False)):
            slot = (keys[:N] & 0x7FFFFFFF) % S
            w, f = ((words[:N], floats[:N]) if view
                    else (words[:N].clone(), floats[:N].clone()))
            where = (f"N={N} S={S} {'view' if view else 'aligned'} "
                     f"({ga.plan(S, N).path})")
            if not torch.equal(ga.grouped_sum_u32(slot, w, S),
                               ref.grouped_sum_u32(slot, w, S)):
                raise AssertionError(f"grouped_sum_u32 differs: {where}")
            if not torch.allclose(ga.grouped_agg(slot, f, S),
                                  ref.grouped_agg(slot, f, S),
                                  atol=1e-3, rtol=1e-4):
                raise AssertionError(f"grouped_agg outside atol 1e-3 rtol "
                                     f"1e-4: {where}")
            cases += 2
        for chunks, owners in ((1, 1), (4, 1), (4, 4)):
            got = ga.grouped_sum_u32_by_key(keys, words, S, chunks=chunks,
                                            n=owners)
            if not torch.equal(got, ref.grouped_sum_u32_by_key(
                    keys, words, S, chunks=chunks, n=owners)):
                raise AssertionError(
                    f"grouped_sum_u32_by_key differs: misaligned N="
                    f"{keys.shape[0]} G={S} chunks={chunks} n={owners}")
            cases += 1
    del base, keys, words, floats
    # a slot outside [0, S) is skipped, never written
    slot = torch.tensor([-1, 0, 5, 1], dtype=torch.int32, device=dev)
    one = torch.ones(4, dtype=torch.int32, device=dev)
    for path in ("shared", "global", "partition"):
        p = ga.plan(2, 4, ga.device_info(dev), path=path)
        if ga.grouped_sum_u32(slot, one, 2, plan=p).tolist() != [1, 1]:
            raise AssertionError(f"grouped_sum_u32 ({path}) wrote an "
                                 "out-of-range slot")
    return cases + 3


def check_radix_join(quick: bool, stats: dict):
    """rank + scatter bit-exact against ref at a join's route: A requests
    (10 % filtered), one shard, cap = 2A, rows of (key, value)."""
    import torch
    from repro_torch.kernels import radix_partition as rp, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(15)
    A = OLAP_QUICK_N if quick else OLAP_N
    dest = (torch.rand((A,), generator=g, device=dev) < 0.1).to(torch.int32)
    rows = torch.randint(-2 ** 31, 2 ** 31 - 1, (A, 2), generator=g,
                         device=dev, dtype=torch.int32)
    got = rp.rank(dest, 1, 2 * A)
    for x, y, what in zip(got, ref.rank(dest, 1, 2 * A),
                          ("slot", "keep", "overflow", "counts")):
        if not torch.equal(x, y):
            raise AssertionError(f"radix rank {what} differs at A={A}")
    kb = rp.scatter(rows, got[0], 2 * A, counts=got[3])
    if not torch.equal(kb, ref.scatter(rows, got[0], 2 * A, counts=got[3])):
        raise AssertionError(f"radix scatter differs at A={A}")
    del kb
    torch.cuda.empty_cache()
    return A


def grouped_olap_slots() -> tuple:
    """The table sizes the OLAP path gives grouped_agg: Fig 8b's kernel
    row (2048), and for each G of the sweep Dist-AGG's G slots and
    RDMA-AGG's 4G (4 chunks, one owner)."""
    from repro_torch.bench import fig8b_agg
    return tuple(sorted({fig8b_agg.KERNEL_SLOTS}
                        | {G for G in fig8b_agg.GROUPS}
                        | {4 * G for G in fig8b_agg.GROUPS}))


def time_grouped(quick: bool, record: dict) -> dict:
    """The grouped_agg entries at every table size of the OLAP path
    (grouped_olap_slots): N rows of Fig 8b's table (keys uniform in [0,
    2**30), unit values), the f32 and u32 slot entries on ``key % S`` and
    the keys entry in the layout the path calls at that S (Dist-AGG: G
    slots; RDMA-AGG: 4 chunks of G); and the skewed case (90 % of the rows
    in one slot) at 2**26.  Each: per call (CUDA events), device time
    (profiler), host issue, the bytes bound (8N + 4S) and index_add_.
    The JSON record takes the f32 entry at 2048 slots and the u32 entry
    at 2**26."""
    import torch
    from repro_torch.bench import fig8b_agg
    from repro_torch.kernels import grouped_agg as ga, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    N = OLAP_QUICK_N if quick else OLAP_N
    keys = torch.randint(0, 1 << 30, (N,), generator=g, device=dev,
                         dtype=torch.int32)
    vals = {"f32": torch.ones((N,), dtype=torch.float32, device=dev),
            "u32": torch.ones((N,), dtype=torch.int32, device=dev)}
    groups = set(fig8b_agg.GROUPS)
    out = {}
    cases = [(S, False) for S in grouped_olap_slots()] + [(1 << 26, True)]
    for S, skew in cases:
        k = keys
        if skew:
            hot = torch.rand((N,), generator=g, device=dev) < 0.9
            k = torch.where(hot, torch.full_like(keys, S // 2), keys)
        slot = (k % S).to(torch.int32)
        calls = {"grouped_agg": ("f32", lambda: ga.grouped_agg(
                     slot, vals["f32"], S), lambda: ref.grouped_agg(
                     slot, vals["f32"], S)),
                 "grouped_sum_u32": ("u32", lambda: ga.grouped_sum_u32(
                     slot, vals["u32"], S), lambda: ref.grouped_sum_u32(
                     slot, vals["u32"], S))}
        if S in groups or skew:
            calls["grouped_sum_u32_by_key"] = (
                "u32", lambda: ga.grouped_sum_u32_by_key(k, vals["u32"], S),
                None)
        if S % 4 == 0 and S // 4 in groups and not skew:
            calls["grouped_sum_u32_by_key/4_chunks"] = (
                "u32", lambda: ga.grouped_sum_u32_by_key(
                    k, vals["u32"], S // 4, chunks=4), None)
        for name, (ent, kern, plain) in calls.items():
            v = vals[ent]
            lib = torch.zeros((S,), dtype=v.dtype, device=dev)
            t = {"ms": time_ms(kern),
                 "device_ms": device_ms(kern, ga.KERNELS[ent]),
                 "host_ms": host_ms(kern),
                 "bound_ms": bound_ms(8 * N + 4 * S), "bound_by": "bytes",
                 "library_ms": time_ms(
                     lambda: lib.zero_().index_add_(0, slot, v), iters=5),
                 "path": ga.plan(S, N, ga.device_info(dev)).path,
                 "shape": {"N": N, "S": S, "skewed": skew}}
            if (name, S) in (("grouped_agg", 2048),
                             ("grouped_sum_u32", 1 << 26)) and not skew:
                t["plain_ms"] = time_ms(plain, iters=5)
                record[name].update(t)
            out[f"{name}@S={S}{'/skewed' if skew else ''}"] = t
            del lib
        del slot, k
        torch.cuda.empty_cache()
    return out


def time_radix_join(quick: bool) -> dict:
    """rank and scatter at a join's route (A rows of (key, value), one
    shard, cap = 2A), beside their plain versions and index_copy_."""
    import torch
    from repro_torch.kernels import radix_partition as rp, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    A = OLAP_QUICK_N if quick else OLAP_N
    dest = torch.zeros((A,), dtype=torch.int32, device=dev)
    rows = torch.randint(-2 ** 31, 2 ** 31 - 1, (A, 2), generator=g,
                         device=dev, dtype=torch.int32)
    out = {"radix_partition_rank@join": {
        "ms": time_ms(lambda: rp.rank(dest, 1, 2 * A), iters=5),
        "device_ms": device_ms(lambda: rp.rank(dest, 1, 2 * A),
                               rp.KERNELS["rank"], iters=5),
        "scan_device_ms": device_ms(lambda: rp.rank(dest, 1, 2 * A),
                                    ("scan_kernel",), iters=5),
        "host_ms": host_ms(lambda: rp.rank(dest, 1, 2 * A), iters=10),
        "plain_ms": time_ms(lambda: ref.rank(dest, 1, 2 * A), iters=5),
        "bound_ms": bound_ms(4 * A + 4 * A + 2 * A + 4), "bound_by": "bytes",
        "library_ms": None, "shape": {"A": A, "n": 1, "cap": 2 * A}}}
    slot, _, _, counts = rp.rank(dest, 1, 2 * A)
    wide = torch.cat([rows, torch.ones((A, 1), dtype=torch.int32,
                                       device=dev)], 1)
    buf = torch.zeros((2 * A, 3), dtype=torch.int32, device=dev)
    kslot = slot.to(torch.int64)

    def kern():
        return rp.scatter(rows, slot, 2 * A, counts=counts)
    t = out["radix_partition_scatter@join"] = {
        "ms": time_ms(kern, iters=5),
        "device_ms": device_ms(kern, rp.KERNELS["scatter"], iters=5),
        "host_ms": host_ms(kern, iters=10),
        "plain_ms": time_ms(lambda: ref.scatter(rows, slot, 2 * A,
                                                counts=counts), iters=5),
        "bound_ms": bound_ms(A * 8 + A * 4 + 2 * A * 3 * 4),
        "bound_by": "bytes",
        "library_ms": time_ms(lambda: buf.index_copy_(0, kslot, wide),
                              iters=5),
        "shape": {"A": A, "w": 2, "slots": 2 * A}}
    t["bound_share"] = t["bound_ms"] / t["ms"]
    del rows, wide, buf, kslot, slot
    torch.cuda.empty_cache()
    return out


def time_kernels(record: dict):
    """Each kernel at the main path's shapes: a commit wave of T=4096
    checkouts (A = T*W requests, one shard) on the 1 131 072-record
    table, install rows of 259 lanes."""
    import torch
    from repro_torch._bits import LOCK_BIT
    from repro_torch.bench.checkout import (PAYLOAD_WORDS, PRODUCTS, W_INSERT,
                                            W_READ)
    from repro_torch.kernels import cas_lock as ck, radix_partition as rp, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    W = W_READ + W_INSERT
    A = MAIN_T * W
    R = PRODUCTS + MAIN_WAVES * MAIN_T * W_INSERT
    n, cap = 1, A

    dest = torch.zeros((A,), dtype=torch.int32, device=dev)
    record["radix_partition_rank"].update(
        ms=time_ms(lambda: rp.rank(dest, n, cap)),
        device_ms=device_ms(lambda: rp.rank(dest, n, cap),
                            rp.KERNELS["rank"]),
        scan_device_ms=device_ms(lambda: rp.rank(dest, n, cap),
                                 ("scan_kernel",)),
        host_ms=host_ms(lambda: rp.rank(dest, n, cap)),
        plain_ms=time_ms(lambda: ref.rank(dest, n, cap)),
        bound_ms=bound_ms(A * 4 + A * 4 + 2 * A + n * 4),
        bound_by="bytes", library_ms=None,
        shape={"A": A, "n": n, "cap": cap})

    w = PAYLOAD_WORDS + 3                      # install: rec, val, npay, do_pay
    rows = torch.randint(-2 ** 31, 2 ** 31 - 1, (A, w), generator=g,
                         device=dev, dtype=torch.int32)
    slot, _, _, counts = rp.rank(dest, n, cap)
    mask = torch.rand((A,), generator=g, device=dev) < 0.9
    kept = int(mask.sum())
    wide = torch.cat([rows, torch.ones((A, 1), dtype=torch.int32,
                                       device=dev)], 1)
    sel = mask.nonzero()[:, 0]
    kslot, krows = slot[sel].to(torch.int64), wide[sel]
    buf = torch.zeros((n * cap, w + 1), dtype=torch.int32, device=dev)

    def scatter():
        return rp.scatter(rows, slot, n * cap, counts=counts, mask=mask)

    def lib_copy():
        return buf.index_copy_(0, kslot, krows)
    record["radix_partition_scatter"].update(
        ms=time_ms(scatter),
        device_ms=device_ms(scatter, rp.KERNELS["scatter"]),
        host_ms=host_ms(scatter),
        plain_ms=time_ms(lambda: ref.scatter(rows, slot, n * cap,
                                             counts=counts, mask=mask)),
        bound_ms=bound_ms(kept * w * 4 + A * 4 + A + n * cap * (w + 1) * 4),
        bound_by="bytes",
        library_ms=time_ms(lib_copy),
        library_host_ms=host_ms(lib_copy),
        shape={"A": A, "w": w, "slots": n * cap, "kept": kept})
    del rows, wide, krows, buf

    # the prepare CAS: 3 uniform product updates + 4 unborn inserts per txn
    prods = torch.randint(0, PRODUCTS, (MAIN_T, W_READ), generator=g,
                          device=dev, dtype=torch.int32)
    ins = PRODUCTS + torch.arange(MAIN_T * W_INSERT, dtype=torch.int32,
                                  device=dev).reshape(MAIN_T, W_INSERT)
    idx = torch.cat([prods, ins], 1).reshape(-1)
    words = torch.zeros((R,), dtype=torch.int32, device=dev)
    words[:PRODUCTS] = 1
    exp = torch.cat([torch.ones((MAIN_T, W_READ), dtype=torch.int32,
                                device=dev),
                     torch.zeros((MAIN_T, W_INSERT), dtype=torch.int32,
                                 device=dev)], 1).reshape(-1)
    new = exp | LOCK_BIT
    prio = torch.arange(MAIN_T, dtype=torch.int32,
                        device=dev).repeat_interleave(W)
    live = words.clone()

    def restore():
        live.copy_(words)
    ok = ck.cas(live, idx, exp, new, prio)
    winners = int(ok.sum())
    touched = int(torch.unique(idx).numel())
    key = ((prio.to(torch.int64) + 2 ** 31) << 32) | torch.arange(
        A, dtype=torch.int64, device=dev)
    best = torch.full((R,), -1, dtype=torch.int64, device=dev)
    idx64 = idx.to(torch.int64)

    def lib_call():
        best.scatter_reduce_(0, idx64, key, reduce="amin")

    def call():
        return ck.cas(live, idx, exp, new, prio)
    # one device operation a call, and no fill
    ops_per_call = device_ops(call)
    if (sum(ops_per_call.values()) != 1
            or any(k.startswith("Memset") for k in ops_per_call)):
        raise AssertionError(f"a cas call is not one device operation: "
                             f"{ops_per_call}")
    record["cas_lock"].update(
        ms=time_ms(call, setup=restore),
        device_ms=device_ms(call, ck.KERNELS["cas"], setup=restore),
        host_ms=host_ms(call, setup=restore),
        device_ops=ops_per_call,
        plain_ms=time_ms(lambda: ref.cas(live, idx, exp, new, prio),
                         setup=restore),
        bound_ms=bound_ms(A * 16 + touched * 4 + A + winners * 4),
        bound_by="bytes",
        library_ms=time_ms(lib_call, setup=lambda: best.fill_(-1)),
        library_host_ms=host_ms(lib_call, setup=lambda: best.fill_(-1)),
        shape={"R": R, "A": A, "winners": winners})


FLASH_SWEEP = (     # (B, S, T, H, KH, D, causal): tests/test_kernels.py:47-52,
    (2, 128, 128, 4, 4, 32, True),      # then ragged S/T, GQA 1/8/16 and
    (2, 256, 256, 4, 2, 32, True),      # D from 8 to 128
    (2, 128, 256, 8, 1, 64, False),
    (2, 100, 100, 8, 2, 24, True),
    (1, 77, 133, 4, 4, 40, False),
    (1, 64, 100, 4, 2, 64, True),
    (1, 65, 65, 2, 2, 8, True),
    (1, 300, 300, 32, 4, 128, True),
    (1, 200, 200, 16, 1, 128, True),
    (2, 257, 257, 32, 2, 128, True),
    (1, 2048, 2048, 4, 2, 64, True),    # long: tiles far from the start,
    (1, 2048, 2048, 8, 2, 128, True),   # f32 held at 2e-5
    (2, 200, 330, 16, 2, 128, False),   # ragged across the bf16 body's
    (1, 4096, 4096, 8, 1, 64, True),    # 128-row tiles; long at D = 64
)
SSD_SWEEP = (       # (B, S, H, hd, N): tests/test_kernels.py:70-74, then
    (2, 64, 8, 16, 16),                 # ragged S, N = 8 and 128, and the
    (2, 128, 4, 32, 8),                 # mamba2 head (hd 64, N 128); then,
    (2, 256, 16, 16, 32),               # for the bf16 body's plans and
    (2, 100, 4, 16, 16),                # padding, hd 24 at N = 256, N =
    (1, 300, 32, 64, 128),              # 1024 (16-step chunks), and hd 20
    (2, 1000, 4, 64, 128),              # at N = 40 (bf16 only: zero-padded
    (1, 200, 4, 24, 256),               # to 24 and 64)
    (1, 130, 2, 16, 1024),
    (1, 150, 3, 20, 40),
)
FLASH_PATH = (1, 8192, 32, 2, 128)      # glm4 prefill: B, S, H, KH, D
SSD_PATH = (8, 8192, 32, 64, 128)       # mamba2 prefill: B, S, H, hd, N


def _normal(g, shape, dtype, dev, scale=1.0):
    import torch
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


def check_flash(stats: dict):
    """flash_attention against ref.flash_attention over FLASH_SWEEP in f32
    (within 2e-5) and bf16 (within 2e-2), the tolerances of
    tests/test_kernels.py:62; in bf16 also each query row's rms difference
    within ROW_TOL of its rms (2e-2 is about the size of a late row's
    values at long S, so it alone would not see a fault there)."""
    import torch
    from repro_torch.bench.serve import row_rel_err
    from repro_torch.kernels import flash_attention as fa, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(18)
    cases = 0
    for B, S, T, H, KH, D, causal in FLASH_SWEEP:
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            q = _normal(g, (B, S, H, D), dtype, dev)
            k = _normal(g, (B, T, KH, D), dtype, dev)
            v = _normal(g, (B, T, KH, D), dtype, dev)
            got = fa.flash_attention(q, k, v, causal=causal).float()
            want = ref.flash_attention(q, k, v, causal=causal).float()
            if not torch.allclose(got, want, atol=tol, rtol=tol):
                raise AssertionError(
                    f"flash_attention outside {tol}: B={B} S={S} T={T} H={H} "
                    f"KH={KH} D={D} causal={causal} {dtype}: max "
                    f"{float((got - want).abs().max())}")
            if dtype == torch.bfloat16:
                row = row_rel_err(got, want)
                if row > ROW_TOL:
                    raise AssertionError(
                        f"flash_attention bf16 row error {row} > {ROW_TOL}: "
                        f"B={B} S={S} T={T} H={H} KH={KH} D={D} "
                        f"causal={causal}")
                stats["flash_bf16_row"] = max(stats["flash_bf16_row"], row)
            key = "flash_f32" if dtype == torch.float32 else "flash_bf16"
            stats[key] = max(stats[key], float((got - want).abs().max()))
            cases += 1
    return cases


def check_ssd(stats: dict):
    """ssd_scan against ref.ssd_scan over SSD_SWEEP: f32 y and final state
    within 2e-3 (tests/test_kernels.py:84), with and without an initial
    state; bf16 inputs, y within 2e-2 relative (one bf16 rounding of y)
    and the f32 state within 2e-3.  N = 1024 runs in bf16 only: the f32
    body refuses it."""
    import torch
    from repro_torch.kernels import ref, ssd_scan as sk
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)
    cases = 0
    for B, S, H, P, N in SSD_SWEEP:
        for dtype, tol in ((torch.float32, 2e-3), (torch.bfloat16, 2e-2)):
            if not sk.takes_state_dim(N, dtype):        # f32 at N = 1024
                continue
            xh = _normal(g, (B, S, H, P), dtype, dev, 0.5)
            bv = _normal(g, (B, S, N), dtype, dev, 0.5)
            cv = _normal(g, (B, S, N), dtype, dev, 0.5)
            dt = torch.nn.functional.softplus(
                torch.randn((B, S, H), generator=g, device=dev))
            a = -torch.exp(torch.randn((H,), generator=g, device=dev) * 0.3)
            for s0 in (None, _normal(g, (B, H, P, N), torch.float32, dev)):
                y, st = sk.ssd_scan(xh, bv, cv, dt, a, s0)
                yr, str_ = ref.ssd_scan(xh, bv, cv, dt, a, s0)
                where = (f"B={B} S={S} H={H} hd={P} N={N} {dtype} "
                         f"state0={s0 is not None}")
                if not torch.allclose(y.float(), yr.float(), atol=tol,
                                      rtol=tol):
                    raise AssertionError(
                        f"ssd_scan y outside {tol}: {where}: max "
                        f"{float((y.float() - yr.float()).abs().max())}")
                if not torch.allclose(st, str_, atol=2e-3, rtol=2e-3):
                    raise AssertionError(
                        f"ssd_scan state outside 2e-3: {where}: max "
                        f"{float((st - str_).abs().max())}")
                stats["ssd"] = max(stats["ssd"], float(
                    (y.float() - yr.float()).abs().max()))
                cases += 1
    return cases


def time_flash(record: dict) -> dict:
    """flash_attention at one glm4 layer's prefill (B=1, S=8192, H=32,
    KH=2, D=128, bf16, causal), held to its plain version there, beside
    scaled_dot_product_attention (timed only: the port never calls it).
    Held within 2e-2 and, row by row, within ROW_TOL; a control, the plain
    version with one key tile dropped, must read above ROW_TOL.  Bound: the
    larger of the causal FLOPs (4 D H per unmasked pair, S(S+1)/2 pairs) at
    989 TFLOP/s and q, k, v, o once at 3.35 TB/s."""
    import torch
    import torch.nn.functional as F
    from repro_torch.bench.serve import row_rel_err
    from repro_torch.kernels import flash_attention as fa, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20)
    B, S, H, KH, D = FLASH_PATH
    q = _normal(g, (B, S, H, D), torch.bfloat16, dev)
    k = _normal(g, (B, S, KH, D), torch.bfloat16, dev)
    v = _normal(g, (B, S, KH, D), torch.bfloat16, dev)
    got = fa.flash_attention(q, k, v).float()
    want = ref.flash_attention(q, k, v).float()
    err = float((got - want).abs().max())
    row = row_rel_err(got, want)
    control = row_rel_err(_attn_tile_dropped(q, k, v), want)
    if not torch.allclose(got, want, atol=2e-2, rtol=2e-2):
        raise AssertionError(f"flash_attention outside 2e-2 at the glm4 "
                             f"prefill shape: max {err}")
    if not row <= ROW_TOL < control:
        raise AssertionError(f"flash_attention at the glm4 prefill shape: "
                             f"row error {row}, control {control}, limit "
                             f"{ROW_TOL}")
    del got, want
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    flops = 4 * B * H * D * S * (S + 1) // 2
    nbytes = 2 * (q.numel() * 2 + k.numel() * 2)
    t = {"ms": time_ms(lambda: fa.flash_attention(q, k, v), iters=10),
         "device_ms": device_ms(lambda: fa.flash_attention(q, k, v),
                                fa.KERNELS["flash"], iters=5),
         "plain_ms": time_ms(lambda: ref.flash_attention(q, k, v), iters=3,
                             warmup=1),
         "bound_ms": max(bound_ms(nbytes), flops / BF16_FLOP_PER_S * 1e3),
         "bound_by": ("operations" if flops / BF16_FLOP_PER_S
                      > nbytes / HBM_BYTES_PER_S else "bytes"),
         "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
             qt, kt, vt, is_causal=True, enable_gqa=True), iters=10),
         "flops": flops, "bytes": nbytes, "path_max_abs_err": err,
         "path_row_err": row, "path_row_err_control": control,
         "shape": {"B": B, "S": S, "H": H, "KH": KH, "D": D,
                   "dtype": "bf16", "causal": True}}
    t["tflop_per_s"] = flops / t["ms"] / 1e9
    t["bound_share"] = t["bound_ms"] / t["ms"]
    record["flash_attention"].update(t)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return t


def time_f32_entries() -> dict:
    """The f32 entries of flash_attention (``flash_f32``, an FMA body) and
    ssd_scan (``ssd_kernel``, the recurrence) at the shapes of the f32
    full-depth witnesses (FLASH_PATH and SSD_PATH in f32: glm4-9b's and
    mamba2-370m's prefill), held to their plain versions within the
    sweeps' f32 tolerances (2e-5; y and state 2e-3), timed beside them
    and, for flash_f32, beside SDPA on the same f32 inputs (no one
    PyTorch call computes the SSD scan).  Bound: the larger of the operations at 67 TFLOP/s (both bodies run
    outside the tensor cores; the SSD's recurrence, 4 B S H hd N) and
    the bytes at 3.35 TB/s."""
    import torch
    from repro_torch.kernels import flash_attention as fa, ref, ssd_scan as sk
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(22)
    B, S, H, KH, D = FLASH_PATH
    q = _normal(g, (B, S, H, D), torch.float32, dev)
    k = _normal(g, (B, S, KH, D), torch.float32, dev)
    v = _normal(g, (B, S, KH, D), torch.float32, dev)
    err = float((fa.flash_attention(q, k, v)
                 - ref.flash_attention(q, k, v)).abs().max())
    if not err <= 2e-5:
        raise AssertionError(f"flash_f32 off at the glm4 witness shape: "
                             f"max {err}")
    flops = 4 * B * H * D * S * (S + 1) // 2
    nbytes = 4 * (2 * q.numel() + 2 * k.numel())
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    F32["flash_f32"].update(
        ms=time_ms(lambda: fa.flash_attention(q, k, v), iters=5),
        plain_ms=time_ms(lambda: ref.flash_attention(q, k, v), iters=3,
                         warmup=1),
        bound_ms=max(bound_ms(nbytes), flops / F32_FLOP_PER_S * 1e3),
        bound_by=("operations" if flops / F32_FLOP_PER_S
                  > nbytes / HBM_BYTES_PER_S else "bytes"),
        library_ms=time_ms(lambda: torch.nn.functional
                           .scaled_dot_product_attention(
                               qt, kt, vt, is_causal=True, enable_gqa=True),
                           iters=5),
        max_abs_err=err, flops=flops, bytes=nbytes,
        shape={"B": B, "S": S, "H": H, "KH": KH, "D": D, "dtype": "f32"})
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    B, S, H, P, N = SSD_PATH
    xh = _normal(g, (B, S, H, P), torch.float32, dev, 0.5)
    bv = _normal(g, (B, S, N), torch.float32, dev, 0.5)
    cv = _normal(g, (B, S, N), torch.float32, dev, 0.5)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=dev))
    a = -torch.exp(torch.randn((H,), generator=g, device=dev) * 0.3)
    y, st = sk.ssd_scan(xh, bv, cv, dt, a)
    yr, sr = ref.ssd_scan(xh, bv, cv, dt, a)
    err = float((y - yr).abs().max())
    serr = float((st - sr).abs().max())
    if not (torch.allclose(y, yr, atol=2e-3, rtol=2e-3)
            and torch.allclose(st, sr, atol=2e-3, rtol=2e-3)):
        raise AssertionError(f"ssd_kernel off at the mamba2 witness shape: "
                             f"y {err}, state {serr}")
    del y, st, yr, sr
    flops = 4 * B * S * H * P * N
    nbytes = 4 * (2 * xh.numel() + 2 * bv.numel() + dt.numel() + H
                  + B * H * P * N)
    F32["ssd_kernel"].update(
        ms=time_ms(lambda: sk.ssd_scan(xh, bv, cv, dt, a), iters=5),
        plain_ms=time_ms(lambda: ref.ssd_scan(xh, bv, cv, dt, a), iters=3,
                         warmup=1),
        bound_ms=max(bound_ms(nbytes), flops / F32_FLOP_PER_S * 1e3),
        bound_by=("operations" if flops / F32_FLOP_PER_S
                  > nbytes / HBM_BYTES_PER_S else "bytes"),
        library_ms=None, max_abs_err=err, state_max_abs_err=serr,
        flops=flops, bytes=nbytes,
        shape={"B": B, "S": S, "H": H, "hd": P, "N": N, "dtype": "f32"})
    del xh, bv, cv, dt
    torch.cuda.empty_cache()
    return F32


def ssd_chunked_flops(B, S, H, P, N, L=256) -> int:
    """Operations of the chunked SSD at chunk L (the JAX model's form):
    per chunk C B^T (2 L^2 N), and per head the causal intra-chunk product
    (L(L+1) P), the inter-chunk read of the state and its update
    (2 L N P each)."""
    chunks = -(-S // L)
    return B * chunks * (2 * L * L * N + H * (L * (L + 1) * P
                                              + 4 * L * N * P))


def time_ssd(record: dict) -> dict:
    """ssd_scan at one mamba2 layer's prefill (B=8, S=8192, H=32, hd=64,
    N=128, bf16 x/B/C, f32 dt and state), held to its plain version
    there.  Bound: the larger of its bytes (each input read once, y and
    the final state written once) at 3.35 TB/s and the chunked form's
    operations at 989 TFLOP/s.  No single PyTorch call computes it."""
    import torch
    from repro_torch.kernels import ref, ssd_scan as sk
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    B, S, H, P, N = SSD_PATH
    xh = _normal(g, (B, S, H, P), torch.bfloat16, dev, 0.5)
    bv = _normal(g, (B, S, N), torch.bfloat16, dev, 0.5)
    cv = _normal(g, (B, S, N), torch.bfloat16, dev, 0.5)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=dev))
    a = -torch.exp(torch.randn((H,), generator=g, device=dev) * 0.3)
    y, st = sk.ssd_scan(xh, bv, cv, dt, a)
    yr, sr = ref.ssd_scan(xh, bv, cv, dt, a)
    err = float((y.float() - yr.float()).abs().max())
    serr = float((st - sr).abs().max())
    if not (torch.allclose(y.float(), yr.float(), atol=2e-2, rtol=2e-2)
            and torch.allclose(st, sr, atol=2e-3, rtol=2e-3)):
        raise AssertionError(f"ssd_scan off at the mamba2 prefill shape: y "
                             f"{err}, state {serr}")
    del y, st, yr, sr
    nbytes = (2 * xh.numel() * 2 + 2 * bv.numel() * 2 + dt.numel() * 4
              + H * 4 + B * H * P * N * 4)
    flops = ssd_chunked_flops(B, S, H, P, N)
    t = {"ms": time_ms(lambda: sk.ssd_scan(xh, bv, cv, dt, a), iters=10),
         "device_ms": device_ms(lambda: sk.ssd_scan(xh, bv, cv, dt, a),
                                sk.KERNELS["ssd"], iters=5),
         "plain_ms": time_ms(lambda: ref.ssd_scan(xh, bv, cv, dt, a),
                             iters=3, warmup=1),
         "bound_ms": max(bound_ms(nbytes), flops / BF16_FLOP_PER_S * 1e3),
         "bound_by": ("operations" if flops / BF16_FLOP_PER_S
                      > nbytes / HBM_BYTES_PER_S else "bytes"),
         "library_ms": None, "flops_chunked": flops,
         "flops_recurrence": 4 * B * S * H * P * N, "bytes": nbytes,
         "path_max_abs_err": err, "path_state_max_abs_err": serr,
         "plan": sk.chunk_plan(P, N),
         "shape": {"B": B, "S": S, "H": H, "hd": P, "N": N}}
    t["bound_share"] = t["bound_ms"] / t["ms"]
    record["ssd_scan"].update(t)
    del xh, bv, cv, dt
    torch.cuda.empty_cache()
    return t


def phase_kernels(quick: bool, record: dict):
    emit("kernels", names=["radix_partition", "cas_lock", "grouped_agg",
                           "flash_attention", "ssd_scan"])
    err = {"rank": 0, "scatter": 0, "cas": 0, "grouped_agg": 0.0,
           "flash_f32": 0.0, "flash_bf16": 0.0, "flash_bf16_row": 0.0,
           "ssd": 0.0}
    t0 = time.perf_counter()
    nf = check_flash(err)
    ns = check_ssd(err)
    nr = check_radix(quick, err)
    nc = check_cas(quick, err)
    ng = check_grouped(quick, err)
    join_a = check_radix_join(quick, err)
    record["radix_partition_rank"]["max_abs_err"] = err["rank"]
    record["radix_partition_scatter"]["max_abs_err"] = err["scatter"]
    record["cas_lock"]["max_abs_err"] = err["cas"]
    record["grouped_agg"]["max_abs_err"] = err["grouped_agg"]
    record["grouped_sum_u32"]["max_abs_err"] = 0
    record["flash_attention"]["max_abs_err"] = max(err["flash_f32"],
                                                   err["flash_bf16"])
    record["ssd_scan"]["max_abs_err"] = err["ssd"]
    timing = {"flash_attention": time_flash(record),
              "ssd_scan": time_ssd(record),
              "f32_entries": time_f32_entries()}
    time_kernels(record)
    timing.update({k: {kk: v for kk, v in record[k].items() if kk not in (
        "source", "replaces", "route", "launches", "paths", "max_abs_err")}
        for k in OLTP_KERNELS})
    timing.update(time_grouped(quick, record))
    timing.update(time_radix_join(quick))
    emit("kernels_checked", flash_cases=nf, ssd_cases=ns, radix_cases=nr,
         cas_cases=nc, grouped_agg_cases=ng, radix_join_A=join_a,
         max_abs_err=err, seconds=time.perf_counter() - t0, gpu=smi(),
         timing=timing)


# ----------------------------------------------------------- main path --

def _count(names, launches: dict, record: dict, path: str):
    """Add a path's launches to the record; fail if it launched none of
    a kernel it runs, or a kernel it does not run."""
    for name in names:
        record[name]["launches"] += launches[name]
        if launches[name] == 0:
            raise AssertionError(f"the {path} path launched no {name}")
    other = {k: v for k, v in launches.items() if v and k not in names}
    if other:
        raise AssertionError(f"the {path} path launched {other}")


def phase_oltp(quick: bool, record: dict):
    import numpy as np
    import torch
    from repro_torch.bench import checkout, fig6_rsi
    from repro_torch.db import Database
    from repro_torch.kernels import ops
    waves = 2 if quick else MAIN_WAVES
    size = {"products": checkout.PRODUCTS,
            "payload_words": checkout.PAYLOAD_WORDS}
    plan = checkout.plan(seed=7, waves=waves, T=MAIN_T, **size)

    def run(db):
        checkout.create_table(db, waves=waves, T=MAIN_T, **size)
        return checkout.drive(db, plan, max_retries=2)

    db = Database(device="cuda")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    masks, sessions, commit_s = run(db)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    _count(OLTP_KERNELS, launches, record, "oltp")
    db_plain = Database(device="cuda", impl="plain")
    masks_p, _, commit_s_p = run(db_plain)
    if ops.launch_counts() != launches:
        raise AssertionError("the plain run launched a kernel")
    # the kernels' path equals the plain path, bit for bit
    for a, b in zip(masks, masks_p):
        if not np.array_equal(a, b):
            raise AssertionError("committed masks differ")
    if db.txn_stats != db_plain.txn_stats:
        raise AssertionError(f"txn_stats differ: {db.txn_stats} vs "
                             f"{db_plain.txn_stats}")
    if db.fabric_stats() != db_plain.fabric_stats():
        raise AssertionError("fabric_stats differ")
    st, stp = db.table("products").store, db_plain.table("products").store
    for k in st:
        if not torch.equal(st[k], stp[k]):
            raise AssertionError(f"store leaf {k} differs")
    del db_plain, stp
    torch.cuda.empty_cache()
    t = db.table("products")
    if t.locked_rows() != 0:
        raise AssertionError(f"{t.locked_rows()} rows left locked")
    n_sessions = waves * MAIN_T
    final_aborts = sum(int((~m).sum()) for m in masks)
    if db.txn_stats["commits"] + final_aborts != n_sessions:
        raise AssertionError("commits + final aborts != sessions")
    readback = checkout.check_readback(db, sessions)
    emit("oltp", sessions=n_sessions, waves=waves,
         commits=db.txn_stats["commits"], final_aborts=final_aborts,
         txn_stats=db.txn_stats, readback=readback,
         wall_s=wall, commit_s=commit_s, commit_s_plain=commit_s_p,
         commit_txn_per_s=n_sessions / sum(commit_s),
         commit_spread=fig6_rsi.spread(commit_s[1:]),
         launches=launches, fabric=db.fabric_stats(), gpu=smi())


def phase_olap(quick: bool, record: dict):
    """Fig 8a's and Fig 8b's queries through the facade at the paper's
    size; each bench module holds every result to its ground truth and,
    on a subset, to the plain path, and raises otherwise.  Then Fig 8b's
    kernel row and the shuffle microbench, each with its own counts."""
    import torch
    from repro_torch.bench import fig8a_joins, fig8b_agg
    from repro_torch.kernels import ops
    n = OLAP_QUICK_N if quick else OLAP_N
    sels = (0.5,) if quick else fig8a_joins.SELS
    groups = (1, 64, 1 << 20) if quick else fig8b_agg.GROUPS
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    a = fig8a_joins.joins(n, device="cuda", sels=sels, plain_sels=sels,
                          profile_sels=PROFILE_SELS)
    t1 = time.perf_counter()
    keys, vals = fig8b_agg.table(n, device="cuda")
    b = fig8b_agg.aggregations(keys, vals, groups=groups,
                               plain_groups=groups,
                               profile_groups=PROFILE_GROUPS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = ops.launch_counts()
    _count(OLAP_KERNELS, launches, record, "olap")

    ops.reset_launch_counts()
    b["kernel_row"] = fig8b_agg.kernel_row(keys, vals)
    row_launches = ops.launch_counts()
    _count(KERNEL_ROW_KERNELS, row_launches, record, "fig8b kernel row")
    del keys, vals
    torch.cuda.empty_cache()

    shuffle = {"rows": n, "chunks": fig8a_joins.ROUTE_CHUNKS}
    for leg, kw in (("overlap_on", {"overlap": True,
                                    "chunks": fig8a_joins.ROUTE_CHUNKS}),
                    ("overlap_off", {})):
        ops.reset_launch_counts()
        shuffle[f"{leg}_s"] = fig8a_joins.shuffle_route_bench(
            n, device="cuda", **kw)
        shuffle[f"{leg}_launches"] = {
            k: v for k, v in ops.launch_counts().items() if v}
    for row in a.pop("rows"):
        emit("olap_join", n=n, **row, gpu=smi())
    for row in b.pop("rows"):
        emit("olap_agg", n=n, **row, gpu=smi())
    emit("olap", n=n, joins_s=t1 - t0, aggs_s=t2 - t1, launches=launches,
         kernel_row_launches=row_launches, shuffle_route=shuffle,
         fig8a=a, fig8b=b, gpu=smi())


def phase_fig6(quick: bool):
    from repro_torch.bench import fig6_rsi
    runs = [("jax_defaults", {}, None),
            ("paper_T1024", fig6_rsi.paper_width(1024), None)]
    if not quick:
        runs += [("paper_T8192", fig6_rsi.paper_width(8192), None),
                 ("paper_T8192_plain", fig6_rsi.paper_width(8192), "plain")]
    for name, kw, impl in runs:
        r = fig6_rsi.measured_local_txn_rate(iters=FIG6_ITERS, impl=impl,
                                             **kw)
        emit("fig6", run=name, impl=impl or "kernel", T=r["T"],
             txn_per_s=r["txn_per_s"], median_s=r["median_s"],
             spread=r["spread"], times_s=r["times_s"],
             committed=r["committed"],
             plan_builds=r["plan_builds"], stats=r["stats"], gpu=smi())


# ----------------------------------------------------------- n shards ---

def check_shard_shapes(quick: bool, record: dict):
    """The rank, the scatter and the CAS bit-exact against their plain
    versions at the shapes the 4-shard path gives them: a commit shard's
    7168 requests into 4 buckets of 7168 (prepare and install widths), a
    home shard's 282 768 words under 28 672 routed requests, and a join
    shard's 32 000 000 requests into 4 buckets of 16 000 000."""
    import torch
    from repro_torch.kernels import cas_lock as ck, radix_partition as rp
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(18)
    errs = {"rank": 0, "scatter": 0, "cas": 0}
    join_a = (OLAP_QUICK_N if quick else OLAP_N) // SHARDS
    for A, cap, widths in ((MAIN_T // SHARDS * 7, MAIN_T // SHARDS * 7,
                            (4, 259)), (join_a, 2 * join_a // SHARDS, (2,))):
        dest = _rand_dest(g, A, SHARDS, dev)
        got, want = rp.rank(dest, SHARDS, cap), ref.rank(dest, SHARDS, cap)
        for x, y, what in zip(got, want, ("slot", "keep", "overflow",
                                          "counts")):
            if not torch.equal(x, y):
                raise AssertionError(f"radix rank {what} differs at the "
                                     f"shards' A={A} cap={cap}")
            errs["rank"] = max(errs["rank"], _err(x, y))
        for w in widths:
            rows = torch.randint(-2 ** 31, 2 ** 31 - 1, (A, w), generator=g,
                                 device=dev, dtype=torch.int32)
            mask = torch.rand((A,), generator=g, device=dev) < 0.9
            kb = rp.scatter(rows, got[0], SHARDS * cap, counts=got[3],
                            mask=mask)
            pb = ref.scatter(rows, got[0], SHARDS * cap, counts=got[3],
                             mask=mask)
            if not torch.equal(kb, pb):
                raise AssertionError(f"radix scatter differs at the shards' "
                                     f"A={A} cap={cap} w={w}")
            errs["scatter"] = max(errs["scatter"], _err(kb, pb))
            del rows, kb, pb
    R, A = 1_131_072 // SHARDS, MAIN_T * 7
    words = torch.randint(0, 4, (R,), generator=g, device=dev,
                          dtype=torch.int32)
    idx = torch.randint(-1, R, (A,), generator=g, device=dev,
                        dtype=torch.int32)
    exp = words[idx.clamp(0, R - 1).to(torch.int64)]
    prio = torch.randint(0, A, (A,), generator=g, device=dev,
                         dtype=torch.int32)
    kw, pw = words.clone(), words.clone()
    ok_k = ck.cas(kw, idx, exp, exp + 8, prio)
    ok_p = ref.cas(pw, idx, exp, exp + 8, prio)
    if not (torch.equal(ok_k, ok_p) and torch.equal(kw, pw)):
        raise AssertionError(f"cas differs at the shards' R={R} A={A}")
    errs["cas"] = _err(kw, pw)
    for name, key in (("radix_partition_rank", "rank"),
                      ("radix_partition_scatter", "scatter"),
                      ("cas_lock", "cas")):
        record[name]["max_abs_err"] = max(record[name].get("max_abs_err")
                                          or 0, errs[key])
    torch.cuda.empty_cache()
    return errs


def shards_oltp(quick: bool, record: dict):
    """The §4.3 checkout on 4 shards against one shard and the plain path
    on 4: the same masks, store, txn_stats; 4x the one-shard launches."""
    import numpy as np
    import torch
    from repro_torch.bench import checkout, fig6_rsi
    from repro_torch.kernels import ops
    waves = 2 if quick else MAIN_WAVES
    size = {"products": checkout.PRODUCTS,
            "payload_words": checkout.PAYLOAD_WORDS}
    plan = checkout.plan(seed=7, waves=waves, T=MAIN_T, **size)
    runs = {}
    for name, shards, impl in (("one", 1, None), ("mesh", SHARDS, None),
                               ("mesh_plain", SHARDS, "plain")):
        db = checkout.database(shards, device="cuda", impl=impl)
        checkout.create_table(db, waves=waves, T=MAIN_T, **size)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        masks, sessions, commit_s = checkout.drive(db, plan, max_retries=0)
        torch.cuda.synchronize()
        runs[name] = {"db": db, "masks": masks, "sessions": sessions,
                      "commit_s": commit_s, "wall_s": time.perf_counter() - t0,
                      "launches": ops.launch_counts()}
    one, mesh, plain = runs["one"], runs["mesh"], runs["mesh_plain"]
    _count(OLTP_KERNELS, mesh["launches"], record, "shards/oltp")
    for k in OLTP_KERNELS:
        if mesh["launches"][k] != SHARDS * one["launches"][k]:
            raise AssertionError(
                f"{k}: {mesh['launches'][k]} launches on {SHARDS} shards, "
                f"{one['launches'][k]} on one")
    if any(plain["launches"].values()):
        raise AssertionError("the plain 4-shard run launched a kernel")
    for other in (one, plain):
        for a, b in zip(mesh["masks"], other["masks"]):
            if not np.array_equal(a, b):
                raise AssertionError("committed masks differ")
        if mesh["db"].txn_stats != other["db"].txn_stats:
            raise AssertionError(f"txn_stats differ: "
                                 f"{mesh['db'].txn_stats} vs "
                                 f"{other['db'].txn_stats}")
        st, sto = (r["db"].table("products").store for r in (mesh, other))
        for k in st:
            if not torch.equal(st[k], sto[k]):
                raise AssertionError(f"store leaf {k} differs")
    if mesh["db"].fabric_stats() != plain["db"].fabric_stats():
        raise AssertionError("fabric_stats differ from the plain path's")
    db = mesh["db"]
    if db.table("products").locked_rows() != 0:
        raise AssertionError("rows left locked")
    readback = checkout.check_readback(db, mesh["sessions"])
    n_sessions = waves * MAIN_T
    emit("shards_oltp", shards=SHARDS, sessions=n_sessions, waves=waves,
         records_a_shard=db.table("products").schema.num_records // SHARDS,
         txn_stats=db.txn_stats, readback=readback,
         commit_s={k: r["commit_s"] for k, r in runs.items()},
         commit_txn_per_s={k: n_sessions / sum(r["commit_s"])
                           for k, r in runs.items()},
         commit_spread={k: fig6_rsi.spread(r["commit_s"][1:])
                        for k, r in runs.items()},
         wall_s={k: r["wall_s"] for k, r in runs.items()},
         launches={k: r["launches"] for k, r in runs.items()},
         fabric=db.fabric_stats(), gpu=smi())


def shards_fig6(quick: bool):
    """The paper_T8192 commit on 4 shards beside 1, in turns (1, 4, 4,
    1), then each under the profiler."""
    from repro_torch.bench import fig6_rsi, profile_commit
    T = 1024 if quick else 8192
    for shards in (1, SHARDS, SHARDS, 1):
        r = fig6_rsi.measured_local_txn_rate(
            iters=FIG6_ITERS, shards=shards, **fig6_rsi.paper_width(T))
        emit("shards_fig6", shards=shards, T=T, txn_per_s=r["txn_per_s"],
             median_s=r["median_s"], spread=r["spread"],
             host_median_s=r["host_median_s"],
             host_spread=fig6_rsi.spread(r["host_times_s"]),
             committed=r["committed"], plan_builds=r["plan_builds"],
             stats=r["stats"], gpu=smi())
    for shards in (1, SHARDS):
        p = profile_commit.profile_fig6(T, shards=shards)
        emit("shards_fig6_profile", **{k: v for k, v in p.items()
                                       if k != "times_s"}, gpu=smi())


def shards_olap(quick: bool, record: dict):
    """The joins at sel 0.5 and the aggregations on 4 shards of N/4
    tuples, each held by the bench modules to its ground truth (the
    joins also to the plain path), then the same queries on one shard,
    which must give the same values."""
    import torch
    from repro_torch.bench import fig8a_joins, fig8b_agg
    from repro_torch.kernels import ops
    n = OLAP_QUICK_N if quick else OLAP_N
    groups = (64, 1 << 20) if quick else SHARD_GROUPS
    out = {}
    for shards in (SHARDS, 1):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        # one join on the plain path: the plain rank's one-hot cumsum
        # over 4 buckets took 35 s a join at 32M rows a shard on an H100
        a = fig8a_joins.joins(n, device="cuda", sels=(0.5,),
                              plain_sels=(0.5,) if shards > 1 else (),
                              plain_variants=("rrj",), shards=shards)
        keys, vals = fig8b_agg.table(n, device="cuda")
        b = fig8b_agg.aggregations(keys, vals, groups=groups, shards=shards)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        if shards > 1:
            _count(OLAP_KERNELS, launches, record, "shards/olap")
        del keys, vals
        torch.cuda.empty_cache()
        out[shards] = (a, b, time.perf_counter() - t0, launches)
    (a4, b4, s4, l4), (a1, b1, s1, l1) = out[SHARDS], out[1]
    for r4, r1 in zip(a4["rows"], a1["rows"]):
        for name, v4 in r4["variants"].items():
            v1 = r1["variants"][name]
            if (v4["value"], v4["dropped"]) != (v1["value"], v1["dropped"]):
                raise AssertionError(f"shards: join {name} differs from "
                                     "one shard")
            emit("shards_join", n=n, shards=SHARDS, sel=r4["sel"],
                 variant=name, value=v4["value"], dropped=v4["dropped"],
                 median_s=v4["median_s"], min_s=v4["min_s"],
                 max_s=v4["max_s"], peak_bytes=v4["peak_bytes"],
                 plain_s=v4.get("plain_s"), one_shard_median_s=v1["median_s"],
                 one_shard_peak_bytes=v1["peak_bytes"], stats=v4["stats"],
                 gpu=smi())
    for r4, r1 in zip(b4["rows"], b1["rows"]):
        for name, v4 in r4["schemes"].items():
            v1 = r1["schemes"][name]
            emit("shards_agg", n=n, shards=SHARDS, groups=r4["groups"],
                 scheme=name, median_s=v4["median_s"], min_s=v4["min_s"],
                 max_s=v4["max_s"], peak_bytes=v4["peak_bytes"],
                 one_shard_median_s=v1["median_s"],
                 one_shard_peak_bytes=v1["peak_bytes"], stats=v4["stats"],
                 gpu=smi())
    emit("shards_olap", n=n, shards=SHARDS, seconds={SHARDS: s4, 1: s1},
         launches={SHARDS: l4, 1: l1}, gpu=smi())


def phase_shards(quick: bool, record: dict):
    t0 = time.perf_counter()
    errs = check_shard_shapes(quick, record)
    shards_oltp(quick, record)
    shards_fig6(quick)
    shards_olap(quick, record)
    for name in ("radix_partition_rank", "radix_partition_scatter",
                 "cas_lock", "grouped_sum_u32"):
        record[name]["paths"] += ", shards"
    emit("shards", shards=SHARDS, max_abs_err=errs,
         seconds=time.perf_counter() - t0, gpu=smi())


# ------------------------------------------------------------ controls --
# Plain versions with a fault a kernel could have: a control reading of a
# check must land above its limit, or the check could not see that fault.

def _attn_tile_dropped(q, k, v, *, causal: bool = True):
    """ref.flash_attention (causal) with the 64-key tile [S/2, S/2 + 64)
    hidden from every query after it, as a kernel that skipped one tile
    would compute."""
    import torch
    B, S, H, D = q.shape
    G = H // k.shape[2]
    lo = S // 2 // 64 * 64
    kk = k.float().repeat_interleave(G, dim=2)
    vv = v.float().repeat_interleave(G, dim=2)
    kpos = torch.arange(k.shape[1], device=q.device)
    out = torch.empty_like(q)
    for s0 in range(0, S, 1024):
        qc = q[:, s0:s0 + 1024].float()
        qpos = torch.arange(s0, s0 + qc.shape[1], device=q.device)[:, None]
        keep = (kpos <= qpos) & ~((kpos >= lo) & (kpos < lo + 64)
                                  & (qpos >= lo + 64))
        sc = torch.einsum("bshd,bthd->bhst", qc, kk) * D ** -0.5
        p = torch.softmax(sc.masked_fill(~keep, -1e30), dim=-1)
        out[:, s0:s0 + 1024] = torch.einsum("bhst,bthd->bshd", p,
                                            vv).to(q.dtype)
    return out


def _ssd_state_dropped(xh, bv, cv, dt, a, state0=None):
    """ref.ssd_scan with the state not carried across the chunk boundary
    nearest S/2, as a kernel that lost its state there would compute."""
    import torch
    from repro_torch.kernels import ref
    mid = max(xh.shape[1] // 2 // 256 * 256, 1)
    y1, _ = ref.ssd_scan(xh[:, :mid], bv[:, :mid], cv[:, :mid], dt[:, :mid],
                         a, state0)
    y2, st = ref.ssd_scan(xh[:, mid:], bv[:, mid:], cv[:, mid:], dt[:, mid:],
                          a)
    return torch.cat([y1, y2], dim=1), st


@contextlib.contextmanager
def faulty_plain(kernel: str):
    """Within the block, ``ops.<kernel>`` with impl="plain" runs the faulty
    control above; the kernel path is left alone."""
    from repro_torch.kernels import ops
    orig = getattr(ops, kernel)
    fault = {"flash_attention": _attn_tile_dropped,
             "ssd_scan": _ssd_state_dropped}[kernel]

    def patched(*args, impl=None, backward=None, **kw):
        if impl == "plain":
            return fault(*args, **kw)
        kw["backward"] = backward
        return orig(*args, impl=impl, **kw)
    setattr(ops, kernel, patched)
    try:
        yield
    finally:
        setattr(ops, kernel, orig)


def phase_serve(quick: bool, record: dict):
    """Each model at its full published config (--quick: 4 layers, S=1024)
    through src/repro_torch/bench/serve.py.  Every timed prefill step must
    launch its model's kernel once a layer and nothing else; every engine
    wave must launch cas_lock and nothing else; the engine's tokens must
    equal the plain engine's; the lock words end at 0.  Logits and layers:

    * every layer's kernel against its plain version on that layer's own
      inputs in a kernel-path forward over the prefill prompt, at every
      position, within ROW_TOL; the same check with a faulty plain path (a
      dropped key tile, a state not carried) on the first layer must read
      above ROW_TOL;
    * the full-depth last-position logits with f32 weights and activations
      within F32_LOGIT_TOL, argmax equal, wherever the plain path with its
      embedding nudged by 2^-20 stays within F32_LOGIT_TOL of itself (a
      model whose depth amplifies that nudge beyond the limit cannot be
      held at full depth; its witness is reported, and the layer check
      holds its kernel).  The bf16 full-depth difference is reported.

    The phase line is printed before a failure is raised."""
    import torch
    from repro_torch.bench import serve
    from repro_torch.kernels import ops
    for arch, kernel in SERVE_ARCHS.items():
        cfg = serve.config(arch, 4 if quick else None)
        batch, seq = serve.PREFILL[arch]
        seq = 1024 if quick else seq
        t0 = time.perf_counter()
        params = serve.weights(cfg, device="cuda")
        torch.cuda.synchronize()
        nbytes = sum(t.numel() * t.element_size() for t in
                     _leaves(params))
        pre = serve.prefill(cfg, params, batch=batch, seq=seq)
        tokens = serve.prompt(cfg, batch, seq, params["embed"].device)
        layers = serve.layer_check(cfg, params, tokens)
        with faulty_plain(kernel):
            layers["control"] = serve.layer_check(cfg, params, tokens,
                                                  groups=1)["max"]
        del tokens
        eng = serve.engine(cfg, params)
        plain = serve.engine(cfg, params, impl="plain")
        del params
        torch.cuda.empty_cache()
        before = ops.launch_counts()
        f32 = serve.f32_witness(cfg, batch=batch, seq=seq, device="cuda")
        _count_f32("flash_f32" if kernel == "flash_attention"
                   else "ssd_kernel", kernel, before)
        torch.cuda.empty_cache()
        failures = []
        for launches in pre["launches"]:
            if launches[kernel] != cfg.num_layers:
                failures.append(f"prefill launched {kernel} "
                                f"{launches[kernel]} times, not "
                                f"{cfg.num_layers}")
        if not (pre["full"]["finite"] and f32["kernel"]["finite"]):
            failures.append("prefill logits not finite")
        if not pre["full"]["step_agrees"]:
            failures.append("the prefill step's token is not the argmax of "
                            "its logits")
        if len(layers["per_layer"]) != cfg.num_layers:
            failures.append(f"the layer check read "
                            f"{len(layers['per_layer'])} kernel calls")
        if layers["max"] > ROW_TOL:
            failures.append(f"layer {layers['worst_layer']}'s {kernel} "
                            f"differs from the plain path by "
                            f"{layers['max']} > {ROW_TOL}")
        if not layers["control"] > ROW_TOL:
            failures.append(f"the layer check read {layers['control']} on "
                            f"a faulty plain path, not above {ROW_TOL}")
        f32["held"] = f32["nudged"]["max_abs_diff"] <= F32_LOGIT_TOL
        if f32["held"] and (f32["kernel"]["max_abs_diff"] > F32_LOGIT_TOL
                            or f32["kernel"]["argmax_agree"] < 1):
            failures.append(f"f32 full-depth logits differ from the plain "
                            f"path by {f32['kernel']['max_abs_diff']} "
                            f"(limit {F32_LOGIT_TOL}), argmax agreement "
                            f"{f32['kernel']['argmax_agree']}")
        if any(v for w in plain["waves"] for v in w["launches"].values()):
            failures.append("the plain engine launched a kernel")
        if eng["outs"] != plain["outs"]:
            failures.append("engine tokens differ from the plain engine's")
        if not (eng["lock_words_zero"] and plain["lock_words_zero"]):
            failures.append("the engine left slot locks held")
        if len(eng["outs"]) != serve.REQUESTS:
            failures.append(f"the engine finished {len(eng['outs'])} "
                            "requests")
        emit("serve", arch=arch, layers=cfg.num_layers,
             weights_bytes=nbytes, prefill=pre, layer_check=layers,
             layer_check_held_to=ROW_TOL, f32_full=f32,
             f32_held_to=F32_LOGIT_TOL,
             engine={k: v for k, v in eng.items() if k != "outs"},
             engine_plain_s=plain["seconds"],
             tokens_equal=eng["outs"] == plain["outs"], failures=failures,
             seconds=time.perf_counter() - t0, gpu=smi())
        if failures:
            raise AssertionError(f"serve {arch}: " + "; ".join(failures))
        for launches in pre["launches"]:
            _count((kernel,), launches, record, f"serve {arch} prefill")
        for w in eng["waves"]:
            _count(("cas_lock",), w["launches"], record,
                   f"serve {arch} engine wave")
        del pre, eng, plain


def _layer_check(cfg, params, tokens, kernel: str) -> dict:
    """bench.serve.layer_check at a training forward's shapes and dtypes
    (f32 masters, bf16 activations: the kernels' bf16 entries, which every
    training step launches): each layer's kernel against its plain version
    on that layer's own inputs, every position; and the same reading of
    the first layer with a faulty plain path (``faulty_plain``)."""
    import torch
    from repro_torch.bench import serve
    with torch.no_grad():
        out = serve.layer_check(cfg, params, tokens)
        with faulty_plain(kernel):
            out["control"] = serve.layer_check(cfg, params, tokens,
                                               groups=1)["max"]
    return out


def _grad_check(cfg, params, batch, kernel: str) -> dict:
    """Unclipped gradients of ``batch`` on the kernel path against the
    plain path (the functions the model trains through), leaf by leaf
    (``bench.train.leaf_check``: rms(diff) / rms(plain)).  The kernel
    path's launches here are a comparison's and count on no path.

    * ``f32``: both paths with f32 activations (the kernels' f32 entries):
      the autograd Functions' plumbing, held within GRAD_TOL; a faulty
      plain path (``faulty_plain``) must read above it.
    * ``bf16``: bf16 activations, as training runs.  Each leaf's kernel
      path reading must lie within that leaf's ``rounding``: the plain
      path's bf16 gradient against its f32 gradient, the spread bf16
      rounding alone gives the plain path.  A fault smaller than that
      spread cannot show here (the faulty plain path's readings are
      reported, ``control_per_leaf``); the layer check holds the bf16
      kernels themselves."""
    import torch
    from repro_torch.bench import train as bt
    from repro_torch.models import lm
    from repro_torch.train.train_step import build_grad_step
    inf = float("inf")
    names = bt.leaf_names(params)

    def grads(**kw):
        g, m = build_grad_step(cfg, max_grad_norm=inf, **kw)(params, batch)
        return g, float(m["loss"]), float(m["grad_norm"])

    from repro_torch.kernels import ops
    saved = lm.ACT_DTYPE
    lm.ACT_DTYPE = torch.float32
    try:
        before = ops.launch_counts()
        gk, lk, nk = grads()
        _count_f32("flash_f32" if kernel == "flash_attention"
                   else "ssd_kernel", kernel, before)
        gp32, lp, np_ = grads(impl="plain")
        chk = bt.leaf_check(gk, gp32)
        f32 = {"max": chk["max"], "worst_leaf": names[chk["worst_leaf"]],
               "loss": [lk, lp], "grad_norm": [nk, np_]}
        with faulty_plain(kernel):
            gf, _, _ = grads(impl="plain")
        f32["control"] = bt.leaf_check(gk, gf)["max"]
        del gk, gf
        torch.cuda.empty_cache()
    finally:
        lm.ACT_DTYPE = saved
    gk, lk, nk = grads()
    gp, lp, np_ = grads(impl="plain")
    per = bt.leaf_check(gk, gp)["per_leaf"]
    rounding = bt.leaf_check(gp, gp32)["per_leaf"]
    del gk, gp32
    torch.cuda.empty_cache()
    with faulty_plain(kernel):
        gf, _, _ = grads(impl="plain")
    ctl = bt.leaf_check(gf, gp)["per_leaf"]
    del gf, gp
    torch.cuda.empty_cache()
    ratio = [p / r if r > 0 else math.inf for p, r in zip(per, rounding)]
    worst = ratio.index(max(ratio))
    bf16 = {"leaves": names, "per_leaf": per, "rounding": rounding,
            "control_per_leaf": ctl, "max_ratio": ratio[worst],
            "worst_leaf": names[worst], "loss": [lk, lp],
            "grad_norm": [nk, np_], "f32_grad_norm": f32["grad_norm"][1]}
    return {"f32": f32, "bf16": bf16}


def _hold_train_checks(name: str, layers: dict, chk: dict, nlayers: int,
                       failures: list):
    """The failures of a model's layer check and gradient check."""
    if len(layers["per_layer"]) != nlayers:
        failures.append(f"{name} layer check read "
                        f"{len(layers['per_layer'])} kernel calls")
    if not layers["max"] <= ROW_TOL:
        failures.append(f"{name} layer {layers['worst_layer']}'s kernel "
                        f"differs from the plain path at training shapes "
                        f"by {layers['max']} > {ROW_TOL}")
    if not layers["control"] > ROW_TOL:
        failures.append(f"{name} layer check read {layers['control']} on a "
                        f"faulty plain path, not above {ROW_TOL}")
    f32, bf16 = chk["f32"], chk["bf16"]
    if not f32["max"] <= GRAD_TOL:
        failures.append(f"{name} f32 gradients differ from the plain "
                        f"path's by {f32['max']} > {GRAD_TOL}")
    if not f32["control"] > GRAD_TOL:
        failures.append(f"{name} f32 gradient check read {f32['control']} "
                        f"on a faulty plain path, not above {GRAD_TOL}")
    if not bf16["max_ratio"] <= 1:
        failures.append(f"{name} bf16 gradient of {bf16['worst_leaf']} "
                        f"differs from the plain path's by "
                        f"{bf16['max_ratio']} times the spread of bf16 "
                        f"rounding")


def check_ps_route(cfg, stats: dict) -> dict:
    """The rank and the scatter at a PS push's shapes for ``cfg`` (S = 4
    rows of the compressed payload's L/4 + L/256 lanes, and of the raw
    payload's L lanes): bit-exact against ref, then timed beside the
    plain version and the bytes bound (rows read once, the buffer written
    once).  No earlier path routes rows this wide."""
    import torch
    from repro_torch.analytics import row_layout
    from repro_torch.kernels import radix_partition as rp, ref
    from repro_torch.models import api
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    S, L = row_layout(sum(math.prod(s) for s in
                          _leaves(api.param_shapes(cfg))))
    out = {}
    dest = torch.zeros((S,), dtype=torch.int32, device=dev)
    got = rp.rank(dest, 1, S)
    for x, y in zip(got, ref.rank(dest, 1, S)):
        if not torch.equal(x, y):
            raise AssertionError(f"radix rank differs at the PS push: A={S}")
    slot, counts = got[0], got[3]
    for name, w in (("compressed", L // 4 + L // 256), ("raw", L)):
        rows = torch.randint(-2 ** 31, 2 ** 31 - 1, (S, w), generator=g,
                             device=dev, dtype=torch.int32)
        kb = rp.scatter(rows, slot, S, counts=counts)
        pb = ref.scatter(rows, slot, S, counts=counts)
        if not torch.equal(kb, pb):
            raise AssertionError(f"radix scatter differs at the {name} PS "
                                 f"push: A={S} w={w}")
        stats["scatter"] = max(stats["scatter"], _err(kb, pb))
        del kb, pb
        # the nearest PyTorch call: index_copy_ of the rows with their
        # valid lane into the wire buffer, at the rank's slots
        wide = torch.cat([rows, torch.ones((S, 1), dtype=torch.int32,
                                           device=dev)], 1)
        buf = torch.zeros((S, w + 1), dtype=torch.int32, device=dev)
        slot64 = slot.to(torch.int64)

        def lib_copy():
            return buf.index_copy_(0, slot64, wide)

        def scatter():
            return rp.scatter(rows, slot, S, counts=counts)
        out[name] = {
            "A": S, "w": w,
            "ms": time_ms(scatter, iters=10),
            "host_ms": host_ms(scatter, iters=20),
            "plain_ms": time_ms(lambda: ref.scatter(rows, slot, S,
                                                    counts=counts), iters=5),
            "bound_ms": bound_ms(S * w * 4 + S * 4 + S * (w + 1) * 4),
            "bound_by": "bytes",
            "library_ms": time_ms(lib_copy, iters=10),
            "library_host_ms": host_ms(lib_copy, iters=20)}
        del rows, wide, buf
        torch.cuda.empty_cache()
    return out


def phase_train(quick: bool, record: dict):
    """First the rank and the scatter at the PS push's shapes
    (check_ps_route).  Then the trainer (src/repro_torch/bench/train.py)
    at mamba2-370m's full config (--quick: 4 layers, S=512), f32 masters
    from seed 0, AdamW
    (cfg.optimizer), SyntheticLM batches of TRAIN_BATCH x TRAIN_SEQ, in
    each of TRAIN_MODES through Trainer.run: losses finite; ssd_scan
    launched twice a layer a step (forward and the remat recompute), the
    rank and the scatter once a push; the raw paramserver(staleness=0)
    losses equal allreduce's within PARITY_RTOL; the compressed
    paramserver(staleness=4) ends at epoch == steps with every push's
    route bytes bench.train.route_bytes(S, L, 256).  Then, on the
    trainer's first batch, the layer check (every layer's bf16 kernel
    against its plain version at the training shapes within ROW_TOL, a
    faulty plain path above it) and the gradient check (kernel vs plain
    path in f32 within GRAD_TOL, a faulty plain path above it; in bf16
    within the spread of bf16 rounding, leaf by leaf), Fig 9 on the card
    (its rows equal to the CPU's), and glm4-9b at full width cut to 2
    layers: one build_grad_step on the kernel path (flash_attention twice
    a layer: forward and recompute) and the same two checks.  Each phase
    line is printed before a failure is raised."""
    import torch
    from repro_torch.bench import train as bt
    from repro_torch.kernels import ops
    from repro_torch.train.train_step import build_grad_step
    dev = torch.device("cuda")
    cfg = bt.config(TRAIN_ARCH, 4 if quick else None)
    seq = 512 if quick else TRAIN_SEQ
    ckpt = ROOT / "build" / "train_ckpt"
    ssd_a_step = 2 * cfg.num_layers
    failures, runs = [], {}
    t0 = time.perf_counter()
    err = {"scatter": 0}
    emit("train_ps_route", arch=cfg.name, **check_ps_route(cfg, err),
         max_abs_err=err, gpu=smi())
    for mode, compress, steps in TRAIN_MODES:
        r = bt.train(cfg, mode=mode, compress=compress, steps=steps,
                     batch=TRAIN_BATCH, seq=seq, device=dev, ckpt_dir=ckpt)
        torch.cuda.empty_cache()
        runs[mode] = r
        bad = []
        if len(r["losses"]) != steps or not all(
                math.isfinite(x) for x in r["losses"]):
            bad.append(f"losses {r['losses']}")
        ps = mode != "allreduce"
        want = {"ssd_scan": ssd_a_step * steps}
        if ps:
            want.update(radix_partition_rank=steps,
                        radix_partition_scatter=steps)
        got = {k: v for k, v in r["launches"].items() if v}
        if got != want:
            bad.append(f"launches {got}, expected {want}")
        if ps:
            rb = bt.route_bytes(r["num_shards"], r["shard_len"], 256,
                                compress)
            if r["epoch"] != steps:
                bad.append(f"epoch {r['epoch']} after {steps} pushes")
            if r["push_route_bytes"] != [rb] * steps:
                bad.append(f"push route bytes {r['push_route_bytes']}, "
                           f"expected {rb} each")
        failures += [f"train {mode}: {b}" for b in bad]
        emit("train", arch=cfg.name, layers=cfg.num_layers, **{
            k: v for k, v in r.items() if k not in ("fabric",)},
            gpu=smi())
        _count(tuple(want), r["launches"], record,
               f"train {cfg.name} {mode}")
    a = runs["allreduce"]["losses"]
    b = runs["paramserver(staleness=0)"]["losses"]
    parity = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    if not parity <= PARITY_RTOL:
        failures.append(f"allreduce and paramserver(staleness=0) losses "
                        f"differ by {parity} relative (> {PARITY_RTOL})")
    del runs
    params = bt.masters(cfg, dev)
    batch = bt.first_batch(cfg, batch=TRAIN_BATCH, seq=seq, device=dev)
    layers = _layer_check(cfg, params, batch["tokens"], "ssd_scan")
    torch.cuda.empty_cache()
    chk = _grad_check(cfg, params, batch, "ssd_scan")
    del params, batch
    torch.cuda.empty_cache()
    _hold_train_checks(cfg.name, layers, chk, cfg.num_layers, failures)
    emit("train_grad_check", arch=cfg.name, layers=cfg.num_layers,
         batch=TRAIN_BATCH, seq=seq, parity_rel=parity,
         parity_rtol=PARITY_RTOL, layer_check=layers,
         layer_check_held_to=ROW_TOL, held_to=GRAD_TOL, **chk, gpu=smi())
    # Fig 9 at the reference's sizes on the card: its rows depend on the
    # schedule and the counters, not on values, so they equal the CPU's
    from repro_torch.bench import fig9_ml
    ops.reset_launch_counts()
    rows, extras = fig9_ml.run(timed=True, device=dev)
    fig9_launches = ops.launch_counts()
    cpu_rows, _ = fig9_ml.run(device="cpu")
    if rows != cpu_rows:
        failures.append("fig9 rows on the card differ from the CPU's")
    emit("train_fig9", rows=rows, measured_s=extras["measured_s"],
         wallclock_s=extras["wallclock_s"], launches=fig9_launches,
         gpu=smi())
    _count(("radix_partition_rank", "radix_partition_scatter"),
           fig9_launches, record, "fig9")
    arch, layers, gb, gs = GLM_GRAD
    gcfg = bt.config(arch, layers)
    gs = 512 if quick else gs
    params = bt.masters(gcfg, dev)
    batch = bt.first_batch(gcfg, batch=gb, seq=gs, device=dev)
    step = build_grad_step(gcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    g, m = step(params, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    finite = all(bool(torch.isfinite(x).all()) for x in _leaves(g))
    del g
    torch.cuda.empty_cache()
    glayers = _layer_check(gcfg, params, batch["tokens"], "flash_attention")
    torch.cuda.empty_cache()
    gchk = _grad_check(gcfg, params, batch, "flash_attention")
    nparams = sum(x.numel() for x in _leaves(params))
    del params, batch
    torch.cuda.empty_cache()
    if launches["flash_attention"] != 2 * layers:
        failures.append(f"glm4 grad step launched flash_attention "
                        f"{launches['flash_attention']} times, not "
                        f"{2 * layers}")
    if not (finite and math.isfinite(float(m["loss"]))):
        failures.append("glm4 grad step not finite")
    _hold_train_checks(gcfg.name, glayers, gchk, layers, failures)
    emit("train_glm4_grad", arch=gcfg.name, layers=layers, batch=gb,
         seq=gs, params=nparams, step_s=step_s, peak_bytes=peak,
         step_loss=float(m["loss"]), launches=launches,
         layer_check=glayers, layer_check_held_to=ROW_TOL,
         held_to=GRAD_TOL, **gchk,
         failures=failures, seconds=time.perf_counter() - t0, gpu=smi())
    if failures:
        raise AssertionError("train: " + "; ".join(failures))
    _count(("flash_attention",), launches, record, f"train {arch} grad")
    record["ssd_scan"]["paths"] += f", train {cfg.name}"
    record["flash_attention"]["paths"] += f", train {arch} grad"
    for name in ("radix_partition_rank", "radix_partition_scatter"):
        record[name]["paths"] += ", train paramserver, fig9"


def _scale_point(fs, W, s, *, sizes: dict, record: dict, path: str,
                 keep_db: bool = False) -> dict:
    """One real-size fig_scale point on the card: the grouped wave with
    its launches counted between a reset and a read, the accounting and
    read-back checks, then the same wave again under torch.profiler."""
    import torch
    from repro_torch.bench import profile_commit
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    st, sets, att, tids, run = fs.run_economics(W, s, device="cuda",
                                                keep=True, **sizes)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    _count(OLTP_KERNELS, launches, record, path)
    sessions = [x for g in run["groups"] for x in g]
    final_aborts = sum(int((~m).sum()) for m in run["masks"])
    if st["commits"] + final_aborts != len(sessions):
        raise AssertionError(f"{path}: commits {st['commits']} + final "
                             f"aborts {final_aborts} != {len(sessions)}")
    t1 = time.perf_counter()
    readback = fs.read_back(run["db"], sessions)
    t2 = time.perf_counter()
    prof = []
    fs.run_economics(W, s, device="cuda", sets=sets,
                     around=lambda: profile_commit._profiled(prof), **sizes)
    out = {"W": W, "skew": s, "sessions": len(sessions),
           "rounds": max(max(a) for a in att), "txn_stats": st,
           "final_aborts": final_aborts, "host_s": run["host_s"],
           "device": {k: prof[0][k] for k in ("device_s", "port_kernels_s",
                                               "device_ops", "by_kernel")},
           "launches": {k: v for k, v in launches.items() if v},
           "readback": readback,
           "seconds": {"run": t1 - t0, "readback": t2 - t1,
                       "profiled_run": time.perf_counter() - t2}}
    return out, (st, sets, att, tids), (run if keep_db else None)


def phase_scale(quick: bool, record: dict):
    """fig_scale (src/repro_torch/bench/fig_scale.py) on the card.

    (a) at the JAX benchmark's sizes (4096 one-word records, 8
    transactions of 2 writes a worker, max_retries 3; --quick: W in 4, 8,
    32): every point on the kernel path and on the plain path, whose
    txn_stats, attempts, transaction ids, committed masks and store
    leaves must be equal, and whose economics must equal a CPU run's
    (which the CPU tests hold to the JAX benchmark); then the three
    panels with the JAX benchmark's asserts.  At the real size, the paper's §4.3 store (1 000 000 records
    of 256 words; 64 transactions a worker, so T = 4096 at W = 64):
    every point's launches counted between a reset and a read, its
    committed writes read back, commits + final aborts == sessions, the
    host seconds of its grouped wave (retry waves included) and the
    device time of the same wave profiled; at W = 64, zipf 1.2 the store
    and txn_stats equal the plain path's.  Then panels (b) and (c) on the
    real-size traces, each install WRITE carrying the real row (1028 B),
    with the simulator's own host seconds."""
    import numpy as np
    import torch
    from repro_torch.bench import checkout, fig_scale as fs
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    workers = (4, 8, 32) if quick else fs.WORKERS
    profiles = fs.DEFAULT_PROFILES

    # (a) at the JAX benchmark's sizes: the kernel path against the plain
    ops.reset_launch_counts()
    kern = {sn: {W: fs.run_economics(W, s, device="cuda", keep=True)
                 for W in workers} for sn, s in fs.SKEWS.items()}
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    _count(OLTP_KERNELS, launches, record, "scale at JAX's sizes")
    diffs = []
    for sn, s in fs.SKEWS.items():
        for W in workers:
            p = fs.run_economics(W, s, device="cuda", impl="plain",
                                 keep=True)
            c = fs.run_economics(W, s, device="cpu")
            k = kern[sn][W]
            same = (k[0] == p[0] == c[0] and k[2] == p[2] == c[2]
                    and k[3] == p[3] == c[3]
                    and all(np.array_equal(a, b) for a, b in
                            zip(k[4]["masks"], p[4]["masks"]))
                    and fs.store_equal(k[4]["db"], p[4]["db"]))
            if not same:
                diffs.append(f"{sn} W={W}")
    if ops.launch_counts() != launches:
        raise AssertionError("the plain runs launched a kernel")
    if diffs:
        raise AssertionError(f"scale: the kernel path differs from the "
                             f"plain path or the CPU at {diffs}")
    t_equal = time.perf_counter() - t0
    econ = {sn: {W: kern[sn][W][:4] for W in workers} for sn in kern}
    del kern
    rows = []
    abort_rate = fs.economics_panel(econ, workers, rows)
    ts = time.perf_counter()
    tput = fs.throughput_panel(econ, workers, profiles, rows)
    ops.reset_launch_counts()
    loc = fs.run_economics(fs.LOCALITY_WORKERS, fs.SKEWS["zipf12"],
                           shared=False, device="cuda")
    loc_launches = ops.launch_counts()
    _count(OLTP_KERNELS, loc_launches, record, "scale locality")
    locality = fs.locality_panel(loc, profiles, rows)
    emit("scale_jax_size", workers=list(workers), abort_rate=abort_rate,
         throughput=tput, locality=locality, rows=rows,
         plain_equal=True, cpu_equal=True,
         launches={k: v for k, v in launches.items()
                                     if v},
         sim_host_s=time.perf_counter() - ts, equal_check_s=t_equal,
         seconds=time.perf_counter() - t0, gpu=smi())

    # the real size: the oltp phase's store
    records, words, txns = (SCALE_QUICK if quick else
                            (checkout.PRODUCTS, checkout.PAYLOAD_WORDS,
                             SCALE_TXNS))
    sizes = {"records": records, "payload_words": words,
             "txns_per_worker": txns}
    real, kept = {}, None
    for sn, s in fs.SKEWS.items():
        real[sn] = {}
        for W in workers:
            keep = sn == "zipf12" and W == max(workers)
            point, econ_pt, run = _scale_point(
                fs, W, s, sizes=sizes, record=record,
                path=f"scale {sn} W={W}", keep_db=keep)
            real[sn][W] = econ_pt
            if keep:
                kept = run
            emit("scale_point", **sizes, **point, gpu=smi())
            torch.cuda.empty_cache()
    plain = fs.run_economics(max(workers), fs.SKEWS["zipf12"], device="cuda",
                             impl="plain", keep=True,
                             sets=real["zipf12"][max(workers)][1], **sizes)
    if not (plain[0] == real["zipf12"][max(workers)][0]
            and fs.store_equal(kept["db"], plain[4]["db"])):
        raise AssertionError("scale: the real-size zipf12 wave differs from "
                             "the plain path")
    del kept, plain
    torch.cuda.empty_cache()
    rows = []
    ts = time.perf_counter()
    tput = fs.throughput_panel(real, workers, profiles, rows,
                               records=records,
                               row_bytes=fs.row_bytes(words))
    sim_b = time.perf_counter() - ts
    ops.reset_launch_counts()
    loc = fs.run_economics(fs.LOCALITY_WORKERS, fs.SKEWS["zipf12"],
                           shared=False, device="cuda", **sizes)
    loc_launches = ops.launch_counts()
    _count(OLTP_KERNELS, loc_launches, record, "scale locality, real size")
    ts = time.perf_counter()
    locality = fs.locality_panel(loc, profiles, rows, records=records,
                                 row_bytes=fs.row_bytes(words))
    sim_c = time.perf_counter() - ts
    emit("scale", **sizes, row_bytes=fs.row_bytes(words),
         workers=list(workers),
         abort_rate={sn: {str(W): real[sn][W][0]["abort_rate"]
                          for W in workers} for sn in real},
         throughput=tput, locality=locality, rows=rows,
         plain_equal_at=f"zipf12 W={max(workers)}",
         sim_host_s={"throughput": sim_b, "locality": sim_c},
         seconds=time.perf_counter() - t0, gpu=smi())


def phase_contention(quick: bool, record: dict):
    """Fig 10 (src/repro_torch/bench/fig10_contention.py) on the card.

    (a) the window sweep, WRITE against SEND, with the JAX benchmark's
    asserts.  (b) the planner prices the paper's §5.4 join (R and S of
    128 000 000 tuples, sel 0.25; --quick: 2^22) at loads 0, 8 and 64 and
    must flip on the RDMA profile.  (c) one GHJ and one RRJ over those
    relations, each recorded through an EventTracer on the kernel path
    (launches counted between a reset and a read) and on the plain path:
    the traces must be equal event for event and the joins equal to the
    ground truth with no dropped row; each trace is replayed on every
    profile (lower bound <= makespan; the window-1 replay equal to the
    analytic sum).  Fig 8a's replay row is printed beside it.  Then
    fabric-check on the card: every suite of repro_torch.fabric.check
    (0 violations), and one 4096-session checkout wave of the oltp store
    through a ScheduleRecorder (launches counted), race-checked: 0
    violations, its access and fence counts and the checker's host
    seconds."""
    import dataclasses as dc
    import torch
    from repro_torch.bench import checkout, fig8a_joins
    from repro_torch.bench import fig10_contention as f10
    from repro_torch.db import Database
    from repro_torch.fabric import LocalTransport, check, netsim
    from repro_torch.kernels import ops
    from repro_torch.configs import OLTP
    t0 = time.perf_counter()
    n = OLAP_QUICK_N if quick else OLAP_N
    rows = []
    windows = {p: {v: {str(w): t for w, t in c.items()}
                   for v, c in f10.sweep_rows(p, rows).items()}
               for p in f10.DEFAULT_PROFILES}

    rk, rv, sk, sv = fig8a_joins.relations(f10.JOIN_SEL, n, device="cuda")
    truth = fig8a_joins.ground_truth(sk, n)
    dbs = {impl: Database(device="cuda", impl=impl,
                          net=f10.DEFAULT_PROFILES[0])
           for impl in (None, "plain")}
    for d in dbs.values():
        d.create_table("R", n, payload_words=1, partitioning="hash")
        d.create_table("S", n, payload_words=1, partitioning="hash")
        d.table("R").load(rk, rv)
        d.table("S").load(sk, sv)
    del rk, rv, sk, sv
    db = dbs[None]
    crossover = f10.planner_rows(db, f10.join_query(db), f10.DEFAULT_PROFILES,
                                 rows)
    profiles = sorted(netsim.PROFILES)
    traces, replay, joins = {}, {}, {}
    for v in CONTENTION_VARIANTS:
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        trace, res = f10.record_join(db, f10.join_query(db), v)
        torch.cuda.synchronize()
        join_s = time.perf_counter() - t1
        launches = ops.launch_counts()
        _count(JOIN_KERNELS, launches, record, f"contention {v}")
        before = ops.launch_counts()
        ptrace, pres = f10.record_join(dbs["plain"],
                                       f10.join_query(dbs["plain"]), v)
        if launches_since(before) != {k: 0 for k in before}:
            raise AssertionError("the plain join launched a kernel")
        value = int(res.value) & 0xFFFFFFFF
        if value != truth or res.dropped != 0 or \
                int(pres.value) & 0xFFFFFFFF != truth:
            raise AssertionError(f"contention {v}: value {value} (truth "
                                 f"{truth}), dropped {res.dropped}")
        if [dc.astuple(e) for e in trace] != [dc.astuple(e) for e in ptrace]:
            raise AssertionError(f"contention {v}: the kernel path's trace "
                                 "differs from the plain path's")
        ts = time.perf_counter()
        replay[v] = f10.replay_rows(trace, profiles, rows, v)
        joins[v] = {"events": [dc.asdict(e) for e in trace],
                    "join_s": join_s, "replay_host_s":
                    time.perf_counter() - ts,
                    "launches": {k: x for k, x in launches.items() if x},
                    "value": value, "trace_equal_plain": True}
    del db, dbs
    torch.cuda.empty_cache()
    emit("contention", n=n, sel=f10.JOIN_SEL, windows=windows,
         crossover=crossover, replay=replay, joins=joins, rows=rows,
         fig8a_replay=fig8a_joins.replay_row(n), gpu=smi())

    # fabric-check on the card
    ts = time.perf_counter()
    reports = check.check_all("cuda")
    summ = check.summarize(reports)
    suites_s = time.perf_counter() - ts
    rec = check.ScheduleRecorder()
    cdb = Database(LocalTransport(recorder=rec, device="cuda"))
    size = {"products": checkout.PRODUCTS,
            "payload_words": checkout.PAYLOAD_WORDS}
    checkout.create_table(cdb, waves=1, T=MAIN_T, **size)
    rec.declare_locks("products/words", ("products/payload",
                                         "products/cids"), lock_bit=1 << 31)
    plan = checkout.plan(seed=7, waves=1, T=MAIN_T, **size)
    ops.reset_launch_counts()
    tw = time.perf_counter()
    ss = checkout.sessions(cdb, plan[0])
    mask = cdb.commit(ss, max_retries=2)
    torch.cuda.synchronize()
    wave_s = time.perf_counter() - tw
    launches = ops.launch_counts()
    _count(OLTP_KERNELS, launches, record, "contention recorded wave")
    tc = time.perf_counter()
    rep = check.check_schedule(rec, target=f"sessions/checkout[T={MAIN_T}]")
    check_s = time.perf_counter() - tc
    wave = {"sessions": len(ss), "committed": int(mask.sum()),
            **rec.summary(), "violations": [str(v) for v in rep.violations],
            "record_wave_s": wave_s, "check_host_s": check_s,
            "launches": {k: v for k, v in launches.items() if v}}
    del cdb, rec
    torch.cuda.empty_cache()
    emit("contention_check", targets=len(reports),
         rules=len(summ["rules_run"]), violations=summ["violations"],
         exemptions=summ["exemptions"], suites_host_s=suites_s, wave=wave,
         oltp_width={"products": OLTP.num_products,
                     "record_bytes": OLTP.record_bytes},
         seconds=time.perf_counter() - t0, gpu=smi())
    if summ["violations"] or not rep.ok:
        raise AssertionError(f"fabric-check on the card: "
                             f"{summ['violations']} {wave['violations']}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------- main ---

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--quick", action="store_true",
                    help="small sweep, 2 waves, serve at 4 layers and "
                    "S=1024, train at 4 layers and S=512 (a first look "
                    "only)")
    ap.add_argument("--out", default=None,
                    help="also append every phase line to this file")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        _OUT.append(open(args.out, "a"))
    record = {
        "radix_partition_rank": {
            "source": "src/repro_torch/kernels/csrc/radix_partition.cu",
            "replaces": "src/repro/kernels/radix_partition.py:59"},
        "radix_partition_scatter": {
            "source": "src/repro_torch/kernels/csrc/radix_partition.cu",
            "replaces": "src/repro/kernels/radix_partition.py:59"},
        "cas_lock": {
            "source": "src/repro_torch/kernels/csrc/cas_lock.cu",
            "replaces": "src/repro/kernels/cas_lock.py:53"},
        "grouped_agg": {
            "source": "src/repro_torch/kernels/csrc/grouped_agg.cu",
            "replaces": "src/repro/kernels/grouped_agg.py:41"},
        "grouped_sum_u32": {
            "source": "src/repro_torch/kernels/csrc/grouped_agg.cu",
            "replaces": "src/repro/kernels/grouped_agg.py:41"},
        "flash_attention": {
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:67"},
        "ssd_scan": {
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:55"},
    }
    paths = {"radix_partition_rank": "oltp, olap, scale, contention",
             "radix_partition_scatter": "oltp, olap, scale, contention",
             "cas_lock": "oltp, serve engine waves, scale, contention "
                         "recorded wave",
             "grouped_agg": "fig8b kernel row", "grouped_sum_u32": "olap",
             "flash_attention": "serve glm4-9b prefill",
             "ssd_scan": "serve mamba2-370m prefill"}
    for name, r in record.items():
        r.update(route="cuda", launches=0, paths=paths[name])
    if "env" in phases:
        phase_env()
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        phase_kernels(args.quick, record)
    if "oltp" in phases:
        phase_oltp(args.quick, record)
    if "olap" in phases:
        phase_olap(args.quick, record)
    if "fig6" in phases:
        phase_fig6(args.quick)
    if "serve" in phases:
        phase_serve(args.quick, record)
    if "shards" in phases:
        phase_shards(args.quick, record)
    if "train" in phases:
        phase_train(args.quick, record)
    if "scale" in phases:
        phase_scale(args.quick, record)
    if "contention" in phases:
        phase_contention(args.quick, record)
    if any(F32.values()):
        emit("f32_entries", **F32, gpu=smi())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "paths")
    print(json.dumps({"kernels": [
        {k: ({"name": name, **r}).get(k) for k in keys}
        for name, r in record.items()]}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
