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

Launch counts are set to 0 just before each path and read just after:
the oltp sessions and commits, the olap queries (Database.execute
alone), Fig 8b's kernel row, the one path of the f32 grouped_agg
entry, in serve each timed prefill step and each engine wave, and in
shards the 4-shard oltp waves and the 4-shard queries; each path must
have launched every kernel it runs.  The shuffle
microbench's launches are reported beside it and counted on no path.
Then three lines: the per-kernel JSON record (launches summed over the
paths named in its "paths"), the card's name and power limit
(nvidia-smi), and {"ok": true, "device": ...}.

    python3 chip_smoke.py            # everything, one card
    python3 chip_smoke.py --phases env,build,kernels --quick
    python3 chip_smoke.py --out smoke.jsonl   # also keep every phase line
    python3 chip_smoke.py --phases env,build,shards   # the n-shard fabric
"""
from __future__ import annotations

import argparse
import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 peak
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor cores
PHASES = ("env", "build", "kernels", "oltp", "olap", "fig6", "serve",
          "shards")
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
              "ssd_scan": time_ssd(record)}
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

    def patched(*args, impl=None, **kw):
        if impl == "plain":
            return fault(*args, **kw)
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
        f32 = serve.f32_witness(cfg, batch=batch, seq=seq, device="cuda")
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
                    "S=1024 (a first look only)")
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
    paths = {"radix_partition_rank": "oltp, olap",
             "radix_partition_scatter": "oltp, olap",
             "cas_lock": "oltp, serve engine waves",
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
