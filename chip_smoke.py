#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

  env      torch / CUDA / nvcc / triton versions, the card and its power
           limit
  build    nvcc builds every kernel source in src/repro_torch/kernels/csrc
           for sm_90a, one process per source, all at once
  kernels  each hand-written kernel held against its plain PyTorch
           version over a sweep of shapes (bit-exact; the f32 grouped_agg
           within atol 1e-3, rtol 1e-4 on random floats), radix_partition
           also at the joins' A = 128 000 000, then each timed at the
           main paths' shapes (per call between CUDA events, and its device
           time from torch.profiler) beside its plain version, the nearest
           single PyTorch call and its bound (bytes / 3.35 TB/s)
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

Launch counts are set to 0 just before each path and read just after:
the oltp sessions and commits, the olap queries (Database.execute
alone), and Fig 8b's kernel row, the one path of the f32 grouped_agg
entry; each path must have launched every kernel it runs.  The shuffle
microbench's launches are reported beside it and counted on no path.
Then three lines: the per-kernel JSON record (launches summed over the
paths named in its "paths"), the card's name and power limit
(nvidia-smi), and {"ok": true, "device": ...}.

    python3 chip_smoke.py            # everything, one card
    python3 chip_smoke.py --phases env,build,kernels --quick
    python3 chip_smoke.py --out smoke.jsonl   # also keep every phase line
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 peak
PHASES = ("env", "build", "kernels", "oltp", "olap", "fig6")
MAIN_T, MAIN_WAVES = 4096, 8     # checkouts per wave, waves (the store's
                                 # widths: configs/paper_nam.py::OLTP)
FIG6_ITERS = 40                  # timed commits per fig6 run
OLAP_N = 128_000_000             # tuples a relation: configs OLAP
OLAP_QUICK_N = 1 << 22
PROFILE_SELS = (0.5,)            # one profiled execution per join here
PROFILE_GROUPS = (64, 67_108_864)  # ... and per aggregation scheme here
OLTP_KERNELS = ("radix_partition_rank", "radix_partition_scatter",
                "cas_lock")
OLAP_KERNELS = ("radix_partition_rank", "radix_partition_scatter",
                "grouped_sum_u32")
KERNEL_ROW_KERNELS = ("grouped_agg",)
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


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build()
    secs = time.perf_counter() - t0
    # ptxas -v: registers / shared memory / spills per kernel
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in report.items()}
    emit("build", seconds=secs, sources=list(report), ptxas=ptxas,
         dir=str(build.BUILD_DIR.relative_to(ROOT)))


def _rand_dest(g, A, n, dev):
    import torch
    # mostly deliverable, some filtered on both sides
    return torch.randint(-2, n + 2, (A,), generator=g, device=dev,
                         dtype=torch.int32)


def check_radix(quick: bool, stats: dict):
    """rank + scatter bit-exact against ref over the sweep."""
    import torch
    from repro_torch.kernels import radix_partition as rp, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    sizes = (1, 1000) if quick else (1, 1000, 1 << 20)
    cases = 0
    for A in sizes:
        for w in (1, 5, 261):
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
                        kb = rp.scatter(rows, got[0], n * cap, mask=m)
                        pb = ref.scatter(rows, got[0], n * cap, mask=m)
                        if not torch.equal(kb, pb):
                            raise AssertionError(
                                f"radix scatter differs: A={A} n={n} "
                                f"cap={cap} w={w} mask={m is not None}")
                        stats["scatter"] = max(stats["scatter"], _err(kb, pb))
                        cases += 1
                    del kb, pb
            del rows
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
    if not bool((ck.arbitration_table(1, dev) == -1).all()):
        raise AssertionError("cas left its arbitration table dirty")
    return cases


def check_grouped(quick: bool, stats: dict):
    """grouped_sum_u32 bit-exact against ref over random u32 words (sums
    wrap), grouped_agg (f32) bit-exact on small signed integers and within
    atol 1e-3, rtol 1e-4 on uniform [0, 1) floats (the f32 atomics add in
    an order that changes from run to run), over N up to 2**27 and S from 1
    to 2**24, both sides of the shared-memory limit; uniform slots, and
    one skewed case per size (90 % of the rows in one slot)."""
    import torch
    from repro_torch.kernels import grouped_agg as ga, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    lim = ga.max_shared_slots()
    slots = (1, 64, 2048, 4096, lim, lim + 1, 262_144, 1 << 24)
    sizes = (1, 1000, 1 << 20) if quick else (1, 1000, 1 << 20, 1 << 27)
    cases = 0
    for N in sizes:
        words = torch.randint(-2 ** 31, 2 ** 31 - 1, (N,), generator=g,
                              device=dev, dtype=torch.int32)
        ints = torch.randint(-8, 9, (N,), generator=g, device=dev
                             ).to(torch.float32)
        floats = torch.rand((N,), generator=g, device=dev)
        for S in slots:
            uni = torch.randint(0, S, (N,), generator=g, device=dev,
                                dtype=torch.int32)
            layouts = [("uniform", uni)]
            if S == 2048:
                layouts.append(("skewed", torch.where(
                    torch.rand((N,), generator=g, device=dev) < 0.9, S // 2,
                    uni)))
            for skew, slot in layouts:
                where = f"N={N} S={S} {skew}"
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
        del words, ints, floats
        torch.cuda.empty_cache()
    # a slot outside [0, S) is skipped, never written
    slot = torch.tensor([-1, 0, 5, 1], dtype=torch.int32, device=dev)
    one = torch.ones(4, dtype=torch.int32, device=dev)
    if ga.grouped_sum_u32(slot, one, 2).tolist() != [1, 1]:
        raise AssertionError("grouped_sum_u32 wrote an out-of-range slot")
    return cases + 1


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
    kb = rp.scatter(rows, got[0], 2 * A)
    if not torch.equal(kb, ref.scatter(rows, got[0], 2 * A)):
        raise AssertionError(f"radix scatter differs at A={A}")
    del kb
    torch.cuda.empty_cache()
    return A


def time_grouped(quick: bool, record: dict) -> dict:
    """Both grouped_agg entries at the OLAP path's shapes: N rows (keys
    uniform in [0, 2**30), unit values) into 2048 slots (Fig 8b's kernel
    row) and into 2**26 slots (Dist-AGG at 67 108 864 groups).  The JSON
    record takes the f32 entry at 2048 slots and the u32 entry at 2**26."""
    import torch
    from repro_torch.kernels import grouped_agg as ga, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    N = OLAP_QUICK_N if quick else OLAP_N
    keys = torch.randint(0, 1 << 30, (N,), generator=g, device=dev,
                         dtype=torch.int32)
    vals = {"grouped_agg": torch.ones((N,), dtype=torch.float32,
                                      device=dev),
            "grouped_sum_u32": torch.ones((N,), dtype=torch.int32,
                                          device=dev)}
    entry = {"grouped_agg": (ga.grouped_agg, ref.grouped_agg),
             "grouped_sum_u32": (ga.grouped_sum_u32, ref.grouped_sum_u32)}
    out = {}
    for S in (2048, 1 << 26):
        slot = (keys % S).to(torch.int32)
        for name, (kern, plain) in entry.items():
            v = vals[name]
            lib = torch.zeros((S,), dtype=v.dtype, device=dev)
            t = {"ms": time_ms(lambda: kern(slot, v, S)),
                 "device_ms": device_ms(lambda: kern(slot, v, S),
                                        ("agg_kernel",)),
                 "plain_ms": time_ms(lambda: plain(slot, v, S), iters=5),
                 "bound_ms": bound_ms(8 * N + 4 * S), "bound_by": "bytes",
                 "library_ms": time_ms(
                     lambda: lib.zero_().index_add_(0, slot, v), iters=5),
                 "shape": {"N": N, "S": S}}
            out[f"{name}@S={S}"] = t
            if (name, S) in (("grouped_agg", 2048),
                             ("grouped_sum_u32", 1 << 26)):
                record[name].update(t)
            del lib
        del slot
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
                               ("hist_kernel", "scan_kernel", "rank_kernel"),
                               iters=5),
        "plain_ms": time_ms(lambda: ref.rank(dest, 1, 2 * A), iters=5),
        "bound_ms": bound_ms(4 * A + 4 * A + 2 * A + 4), "bound_by": "bytes",
        "library_ms": None, "shape": {"A": A, "n": 1, "cap": 2 * A}}}
    slot = rp.rank(dest, 1, 2 * A)[0]
    wide = torch.cat([rows, torch.ones((A, 1), dtype=torch.int32,
                                       device=dev)], 1)
    buf = torch.zeros((2 * A, 3), dtype=torch.int32, device=dev)
    kslot = slot.to(torch.int64)
    out["radix_partition_scatter@join"] = {
        "ms": time_ms(lambda: rp.scatter(rows, slot, 2 * A), iters=5),
        "device_ms": device_ms(lambda: rp.scatter(rows, slot, 2 * A),
                               ("scatter_kernel",), iters=5),
        "plain_ms": time_ms(lambda: ref.scatter(rows, slot, 2 * A), iters=5),
        "bound_ms": bound_ms(A * 8 + A * 4 + 2 * A * 3 * 4),
        "bound_by": "bytes",
        "library_ms": time_ms(lambda: buf.index_copy_(0, kslot, wide),
                              iters=5),
        "shape": {"A": A, "w": 2, "slots": 2 * A}}
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
                            ("hist_kernel", "scan_kernel", "rank_kernel")),
        plain_ms=time_ms(lambda: ref.rank(dest, n, cap)),
        bound_ms=bound_ms(A * 4 + A * 4 + 2 * A + n * 4),
        bound_by="bytes", library_ms=None,
        shape={"A": A, "n": n, "cap": cap})

    w = PAYLOAD_WORDS + 3                      # install: rec, val, npay, do_pay
    rows = torch.randint(-2 ** 31, 2 ** 31 - 1, (A, w), generator=g,
                         device=dev, dtype=torch.int32)
    slot = rp.rank(dest, n, cap)[0]
    mask = torch.rand((A,), generator=g, device=dev) < 0.9
    kept = int(mask.sum())
    wide = torch.cat([rows, torch.ones((A, 1), dtype=torch.int32,
                                       device=dev)], 1)
    sel = mask.nonzero()[:, 0]
    kslot, krows = slot[sel].to(torch.int64), wide[sel]
    buf = torch.zeros((n * cap, w + 1), dtype=torch.int32, device=dev)
    record["radix_partition_scatter"].update(
        ms=time_ms(lambda: rp.scatter(rows, slot, n * cap, mask=mask)),
        device_ms=device_ms(lambda: rp.scatter(rows, slot, n * cap,
                                               mask=mask),
                            ("scatter_kernel",)),
        plain_ms=time_ms(lambda: ref.scatter(rows, slot, n * cap,
                                             mask=mask)),
        bound_ms=bound_ms(kept * w * 4 + A * 4 + A + n * cap * (w + 1) * 4),
        bound_by="bytes",
        library_ms=time_ms(lambda: buf.index_copy_(0, kslot, krows)),
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
    record["cas_lock"].update(
        ms=time_ms(lambda: ck.cas(live, idx, exp, new, prio),
                   setup=restore),
        device_ms=device_ms(lambda: ck.cas(live, idx, exp, new, prio),
                            ("cas_match", "cas_resolve", "cas_finish"),
                            setup=restore),
        plain_ms=time_ms(lambda: ref.cas(live, idx, exp, new, prio),
                         setup=restore),
        bound_ms=bound_ms(A * 16 + touched * 4 + A + winners * 4),
        bound_by="bytes",
        library_ms=time_ms(lib_call, setup=lambda: best.fill_(-1)),
        shape={"R": R, "A": A, "winners": winners})


def phase_kernels(quick: bool, record: dict):
    emit("kernels", names=["radix_partition", "cas_lock", "grouped_agg"])
    err = {"rank": 0, "scatter": 0, "cas": 0, "grouped_agg": 0.0}
    t0 = time.perf_counter()
    nr = check_radix(quick, err)
    nc = check_cas(quick, err)
    ng = check_grouped(quick, err)
    join_a = check_radix_join(quick, err)
    record["radix_partition_rank"]["max_abs_err"] = err["rank"]
    record["radix_partition_scatter"]["max_abs_err"] = err["scatter"]
    record["cas_lock"]["max_abs_err"] = err["cas"]
    record["grouped_agg"]["max_abs_err"] = err["grouped_agg"]
    record["grouped_sum_u32"]["max_abs_err"] = 0
    time_kernels(record)
    timing = {k: {kk: record[k][kk] for kk in (
        "ms", "device_ms", "plain_ms", "bound_ms", "library_ms", "shape")}
        for k in OLTP_KERNELS}
    timing.update(time_grouped(quick, record))
    timing.update(time_radix_join(quick))
    emit("kernels_checked", radix_cases=nr, cas_cases=nc,
         grouped_agg_cases=ng, radix_join_A=join_a,
         seconds=time.perf_counter() - t0, gpu=smi(), timing=timing)


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


# ---------------------------------------------------------------- main ---

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--quick", action="store_true",
                    help="small sweep and 2 waves (a first look only)")
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
    }
    paths = {"radix_partition_rank": "oltp, olap",
             "radix_partition_scatter": "oltp, olap", "cas_lock": "oltp",
             "grouped_agg": "fig8b kernel row", "grouped_sum_u32": "olap"}
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
