#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

  env      torch / CUDA / nvcc / triton versions, the card and its power
           limit
  build    nvcc builds every kernel source in src/repro_torch/kernels/csrc
           for sm_90a, one process per source, all at once
  kernels  each hand-written kernel held bit-exact against its plain
           PyTorch version over a sweep of shapes, then timed at the main
           path's shapes (per call between CUDA events, and its device
           time from torch.profiler) beside its plain version, the nearest
           single PyTorch call and its bound (bytes / 3.35 TB/s)
  oltp     the main path at the paper's §4.3 width: Database(device="cuda")
           with 1 000 000 products of 1 KB (+131 072 insert rows), 8 waves
           of 4096 checkout sessions (Session.begin/get/put ->
           Database.commit, max_retries=2), held against the same waves on
           a second Database whose kernels run their plain versions
  fig6     the fig6 commit batch at the JAX benchmark's sizes and at the
           paper's width (T = 1024, 8192), txn/s from the median of 40
           commits between CUDA events, and their spread

Then three lines: the per-kernel JSON record, the card's name and power
limit (nvidia-smi), and {"ok": true, "device": ...}.

    python3 chip_smoke.py            # everything, one card
    python3 chip_smoke.py --phases env,build,kernels --quick
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
PHASES = ("env", "build", "kernels", "oltp", "fig6")
MAIN_T, MAIN_WAVES = 4096, 8     # checkouts per wave, waves (the store's
                                 # widths: configs/paper_nam.py::OLTP)
FIG6_ITERS = 40                  # timed commits per fig6 run


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


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
                  or any(f"::{k}(" in e.name for k in kernels)))
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
    emit("kernels", names=["radix_partition", "cas_lock"])
    err = {"rank": 0, "scatter": 0, "cas": 0}
    t0 = time.perf_counter()
    nr = check_radix(quick, err)
    nc = check_cas(quick, err)
    record["radix_partition_rank"]["max_abs_err"] = err["rank"]
    record["radix_partition_scatter"]["max_abs_err"] = err["scatter"]
    record["cas_lock"]["max_abs_err"] = err["cas"]
    time_kernels(record)
    emit("kernels_checked", radix_cases=nr, cas_cases=nc,
         seconds=time.perf_counter() - t0, gpu=smi(),
         timing={k: {kk: v[kk] for kk in ("ms", "device_ms", "plain_ms",
                                           "bound_ms", "library_ms", "shape")}
                 for k, v in record.items()})


# ----------------------------------------------------------- main path --

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
    for name, count in launches.items():
        record[name]["launches"] = count
        if count == 0:
            raise AssertionError(f"main path launched no {name}")
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
    }
    for r in record.values():
        r.update(route="cuda", launches=0)
    if "env" in phases:
        phase_env()
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        phase_kernels(args.quick, record)
    if "oltp" in phases:
        phase_oltp(args.quick, record)
    if "fig6" in phases:
        phase_fig6(args.quick)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
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
