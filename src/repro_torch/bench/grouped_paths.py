"""Each path of the grouped_agg kernel across table sizes, on the card.

``grouped_agg.plan`` picks one of three paths for a table of S slots
(shared, global, partition); this module forces each path that can take
S, holds its result to the plain version (u32 entries bit for bit, f32
within atol 1e-3 and rtol 1e-4) and times it beside ``index_add_``, so
the plan's crossovers rest on measured numbers.  Rows are N keys uniform
in [0, 2**30) (Fig 8b's table) with slot ``key % S``, or with 90 % of the
rows in one slot (``skew``).

    PYTHONPATH=src python3 -m repro_torch.bench.grouped_paths \\
        --n 128000000 --slots 2048,67108864 --out paths.jsonl
"""
from __future__ import annotations

import argparse
import json
import re
import statistics

import torch

from repro_torch.kernels import grouped_agg as ga, ref

SLOTS = (64, 2048, 8192, 28_928, 51_200, 262_144, 1 << 20, 1 << 22,
         1 << 24, 1 << 26, 1 << 28)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 peak


def event_ms(fn, *, iters: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` between CUDA events."""
    out = []
    for k in range(warmup + iters):
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


def paths_for(S: int, n: int) -> list:
    """The paths that can take S slots: (name, Plan)."""
    info = ga.device_info("cuda")
    out = []
    for path in ("shared", "global", "partition"):
        try:
            out.append((path, ga.plan(S, n, info, path=path)))
        except ValueError:
            pass
    return out


def rows(n: int, S: int, *, skew: bool, seed: int = 0):
    """(keys, slot, u32 words, f32 values) of n rows on the card."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    keys = torch.randint(0, 1 << 30, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    if skew:
        hot = torch.rand((n,), generator=g, device=dev) < 0.9
        keys = torch.where(hot, torch.full_like(keys, S // 2), keys)
    slot = (keys % S).to(torch.int32)
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=g,
                          device=dev, dtype=torch.int32)
    return keys, slot, words, torch.rand((n,), generator=g, device=dev)


def check(n: int, slots=SLOTS, *, skew_slots=(), seed: int = 0) -> int:
    """Every path of every entry against its plain version; raises on a
    difference.  Returns the number of cases."""
    cases = 0
    for S in slots:
        for skew in (False, True) if S in skew_slots else (False,):
            keys, slot, words, floats = rows(n, S, skew=skew, seed=seed)
            want_u = ref.grouped_sum_u32(slot, words, S)
            want_f = ref.grouped_agg(slot, floats, S)
            for path, p in paths_for(S, n):
                where = f"n={n} S={S} skew={skew} path={path}"
                if not torch.equal(ga.grouped_sum_u32(slot, words, S, plan=p),
                                   want_u):
                    raise AssertionError(f"grouped_sum_u32 differs: {where}")
                got = ga.grouped_agg(slot, floats, S, plan=p)
                if not torch.allclose(got, want_f, atol=1e-3, rtol=1e-4):
                    raise AssertionError(f"grouped_agg outside atol 1e-3 "
                                         f"rtol 1e-4: {where}")
                got = ga.grouped_sum_u32_by_key(keys, words, S, plan=p)
                if not torch.equal(got, want_u):
                    raise AssertionError(f"grouped_sum_u32_by_key differs: "
                                         f"{where}")
                cases += 3
            # RDMA-AGG's phase-1 layouts, on the path the plan picks
            for chunks, owners in ((4, 1), (4, 4)) if S <= 1 << 26 else ():
                got = ga.grouped_sum_u32_by_key(keys, words, S, chunks=chunks,
                                                n=owners)
                want = ref.grouped_sum_u32_by_key(keys, words, S,
                                                  chunks=chunks, n=owners)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"grouped_sum_u32_by_key differs: n={n} S={S} "
                        f"skew={skew} chunks={chunks} owners={owners}")
                cases += 1
            del keys, slot, words, floats, want_u, want_f
            torch.cuda.empty_cache()
    return cases


def time_paths(n: int, slots=SLOTS, *, skew_slots=(), iters: int = 10,
               seed: int = 0) -> list:
    """Per S and path: ms of each entry (CUDA events), the bytes bound of
    the function (8N + 4S) and ``index_add_`` of the same rows."""
    out = []
    for S in slots:
        for skew in (False, True) if S in skew_slots else (False,):
            keys, slot, words, floats = rows(n, S, skew=skew, seed=seed)
            lib = torch.zeros((S,), dtype=torch.int32, device="cuda")
            row = {"S": S, "n": n, "skew": skew,
                   "chosen": ga.plan(S, n, ga.device_info("cuda")).path,
                   "bound_ms": (8 * n + 4 * S) / HBM_BYTES_PER_S * 1e3,
                   "index_add_ms": event_ms(
                       lambda: lib.zero_().index_add_(0, slot, words),
                       iters=iters),
                   "paths": {}}
            for path, p in paths_for(S, n):
                row["paths"][path] = {
                    "u32_ms": event_ms(lambda: ga.grouped_sum_u32(
                        slot, words, S, plan=p), iters=iters),
                    "f32_ms": event_ms(lambda: ga.grouped_agg(
                        slot, floats, S, plan=p), iters=iters),
                    "key_ms": event_ms(lambda: ga.grouped_sum_u32_by_key(
                        keys, words, S, plan=p), iters=iters)}
            out.append(row)
            del keys, slot, words, floats, lib
            torch.cuda.empty_cache()
    return out


def kernel_ms(fn, *, iters: int = 5) -> dict:
    """Device milliseconds a call of ``fn()`` by kernel (``torch.profiler``;
    fills as "Memset"), after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = "Memset" if e.name.startswith("Memset") else re.search(
                r"(\w+)\s*[<(]",
                e.name.replace("(anonymous namespace)::", "")).group(1)
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return {k: v / iters for k, v in out.items()}


def profile_paths(n: int, slots, *, skew_slots=(), seed: int = 0) -> list:
    """Per S and path: the u32 slot entry's device time by kernel."""
    out = []
    for S in slots:
        for skew in (False, True) if S in skew_slots else (False,):
            keys, slot, words, _ = rows(n, S, skew=skew, seed=seed)
            row = {"S": S, "n": n, "skew": skew, "paths": {}}
            for path, p in paths_for(S, n):
                row["paths"][path] = kernel_ms(
                    lambda: ga.grouped_sum_u32(slot, words, S, plan=p))
            out.append(row)
            del keys, slot, words
            torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--check-n", type=int, default=1 << 20)
    ap.add_argument("--slots", default=",".join(map(str, SLOTS)))
    ap.add_argument("--skew", default="2048,67108864",
                    help="slot counts also run with 90 %% of rows in one")
    ap.add_argument("--out", default=None)
    ap.add_argument("--profile", action="store_true",
                    help="device time by kernel instead of the timing")
    args = ap.parse_args(argv)
    slots = [int(s) for s in args.slots.split(",")]
    skew = {int(s) for s in args.skew.split(",") if s}
    if args.check_n:
        cases = check(args.check_n, slots, skew_slots=skew)
        print(json.dumps({"checked": cases, "n": args.check_n}), flush=True)
    run = profile_paths if args.profile else time_paths
    for row in run(args.n, slots, skew_slots=skew):
        line = json.dumps({**row, "gpu": torch.cuda.get_device_name(0)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
