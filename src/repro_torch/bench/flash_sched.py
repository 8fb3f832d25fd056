"""The bf16 flash kernel beside an earlier tree's, checked and timed on
the card (card only).

With ``--parent DIR`` (an unpacked ``git archive`` of an earlier tree) the
kernel source and the wrapper of that tree are built with ``nvcc`` (the
port's flags) into ``build/flash_variants/`` and loaded as a module of
their own (:func:`build_parent`; ``chip_smoke.py --parent`` uses it too).
This tree's wrapper and that one are held to ``ref.flash_attention`` over
SWEEP and at every row of ROWS (within 2e-2, each query row within 2^-6
of its rms; this tree's outputs pre-filled with NaN), then timed at each
row: per call between CUDA events around the wrapper (``ms``), its device
time (``device_ms``, ``torch.profiler``: the kernel's records alone) and
its host issue (``host_ms``, ``time.perf_counter`` around the call, no
sync), in turns (this, parent, parent, this), beside
``scaled_dot_product_attention``'s per-call and device time (all its
kernels) and the host issue of this tree's call by part
(:func:`host_parts`).

    python -m repro_torch.bench.flash_sched --parent build/parent \\
        --out chiprun_out/flash_sched.json
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.kernels import build

ROOT = Path(__file__).resolve().parents[3]
OUT_DIR = ROOT / "build" / "flash_variants"
ROW_TOL = 2 ** -6

# name: (B, S, T, H, KH, D, Dv, causal) -- the path shapes of the body
ROWS = {
    "glm4_causal": (1, 8192, 8192, 32, 2, 128, 128, True),
    "mla": (1, 8192, 8192, 128, 128, 192, 128, True),
    "vlm_cross": (1, 8192, 1601, 64, 8, 128, 128, False),
    "whisper_encoder": (16, 1500, 1500, 8, 8, 64, 64, False),
    "whisper_cross": (16, 448, 1500, 8, 8, 64, 64, False),
}
# (B, S, T, H, KH, D, causal), checked only: S and T either side of the
# 128- and 192-row units, and units just above and below a multiple of
# 132 blocks (133, 263, 133 and 131 units), on each body
SWEEP = tuple((1, S, T, 4, 2, D, c) for D in (64, 128, 192)
              for S, T in ((1, 1), (127, 300), (129, 129), (191, 191),
                           (193, 250), (300, 127), (385, 385))
              for c in (True, False) if not c or S == T) + (
    (1, 100, 300, 133, 7, 64, False), (1, 100, 300, 263, 263, 64, False),
    (1, 180, 180, 133, 19, 64, True), (1, 250, 250, 131, 131, 128, True))


def build_parent(parent) -> object:
    """The wrapper module of the tree at ``parent``, a fresh instance whose
    library (its ``_lib``, so its ``_load`` builds nothing) is that tree's
    kernel source built with the port's flags.  The build's ptxas report
    is the module's ``ptxas``."""
    pk = Path(parent) / "src" / "repro_torch" / "kernels"
    src = pk / "csrc" / "flash_attention.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(build.FLAGS).encode()).hexdigest()[:12]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out = OUT_DIR / f"libflash_parent-{digest}.so"
    proc = subprocess.run([build.nvcc(), *build.FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n"
                           f"{(proc.stdout + proc.stderr)[-4000:]}")
    spec = importlib.util.spec_from_file_location("flash_parent",
                                                  pk / "flash_attention.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [P, P, P, P] + [I] * 9 + [P]
    lib.flash_attention_fwd.restype = I
    mod._lib = lib
    mod.ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr)
                 .splitlines() if "registers" in ln or "spill" in ln]
    return mod


def _events_ms(fn, iters: int, warmup: int = 3) -> float:
    out = []
    for i in range(warmup + iters):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        if i >= warmup:
            out.append(a.elapsed_time(b))
    return statistics.median(out)


def _host_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    out = []
    for i in range(warmup + iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        if i >= warmup:
            out.append((t1 - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(out)


def _device_ms(fn, match, iters: int = 5) -> float:
    """Mean device milliseconds a call of the kernels whose names hold
    ``match`` (every kernel with None), from a torch.profiler trace opened
    with throwaway fills and a pause (a trace can lose its first device
    records); taken again, twice at most, when it holds none."""
    from torch.profiler import ProfilerActivity, profile, record_function
    fn()
    lead = torch.zeros(1, device="cuda")
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                lead.add_(1)
            torch.cuda.synchronize()
            time.sleep(1e-3)
            with record_function("flash_sched.measured"):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
        events = prof.events()
        t0 = next(e.time_range.start for e in events
                  if e.name == "flash_sched.measured")
        us = sum(e.time_range.elapsed_us() for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.time_range.start >= t0 - 500
                 and e.name != "flash_sched.measured"
                 and (match is None or match in e.name))
        if us > 0:
            return us / 1e3 / iters
    raise AssertionError(f"the profiler saw no {match} kernel, thrice")


def inputs(row, seed: int):
    """Seeded bf16 q, k, v on the card for a row of ROWS, and its causal
    flag."""
    B, S, T, H, KH, D, Dv, causal = row
    g = torch.Generator(device="cuda").manual_seed(seed)

    def normal(shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)
    return normal((B, S, H, D)), normal((B, T, KH, D)), \
        normal((B, T, KH, Dv)), causal


def check(mod, q, k, v, causal, want) -> dict:
    """One call of ``mod``'s wrapper held to ``want`` (finite, within 2e-2,
    each row within ROW_TOL), into an output pre-filled with NaN where
    the wrapper takes ``out=`` (a unit the schedule skips stays NaN)."""
    from repro_torch.bench.serve import row_rel_err
    B, S, H, _ = q.shape
    try:
        out = torch.full((B, S, H, v.shape[-1]), float("nan"),
                         dtype=q.dtype, device=q.device)
        got = mod.flash_attention(q, k, v, causal=causal, out=out).float()
    except TypeError:                      # a wrapper with no out=
        got = mod.flash_attention(q, k, v, causal=causal).float()
    err = float((got - want).abs().max())
    row = row_rel_err(got, want)
    ok = bool(torch.isfinite(got).all()) and row <= ROW_TOL and bool(
        torch.allclose(got, want, atol=2e-2, rtol=2e-2))
    return {"max_abs_err": err, "row_err": row, "ok": ok}


def host_parts(mod, q, k, v, causal) -> dict:
    """Host milliseconds to issue one call, by part: the whole wrapper;
    the C entry alone on ready arguments (three tensor-map encodings and
    the launch); reading the current stream; three
    ``cuTensorMapEncodeTiled`` calls through ctypes beside three ctypes
    calls of ``cuDriverGetVersion`` (the calls' own cost)."""
    B, S, H, D = q.shape
    T, KH, Dv = k.shape[1], k.shape[2], v.shape[3]
    out = q.new_empty((B, S, H, Dv))
    stream = torch.cuda.current_stream().cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            T, H, KH, D, Dv, int(causal), 1, stream)
    cuda = ctypes.CDLL("libcuda.so.1")
    encode = cuda.cuTensorMapEncodeTiled
    encode.restype = ctypes.c_int
    raw = ctypes.create_string_buffer(256)
    at = ctypes.c_void_p((ctypes.addressof(raw) + 63) // 64 * 64)
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    maps = [((u64 * 4)(d, h, rows, B), (u64 * 3)(2 * d, 2 * h * d,
                                                  2 * rows * h * d), t)
            for t, d, h, rows in ((q, D, H, S), (k, D, KH, T),
                                  (v, Dv, KH, T))]
    box, step = (u32 * 4)(64, 1, 128, 1), (u32 * 4)(1, 1, 1, 1)
    ver = ctypes.c_int()

    def encode3():       # BFLOAT16 9, SWIZZLE_128B 3, L2_PROMOTION_256B 3
        return [encode(at, 9, 4, ctypes.c_void_p(t.data_ptr()), dims,
                       strides, box, step, 0, 3, 3, 0)
                for dims, strides, t in maps]

    def noop3():
        for _ in range(3):
            cuda.cuDriverGetVersion(ctypes.byref(ver))
    return {"wrapper": _host_ms(lambda: mod.flash_attention(
                q, k, v, causal=causal)),
            "c_entry": _host_ms(lambda: mod._lib.flash_attention_fwd(*args)),
            "stream": _host_ms(
                lambda: torch.cuda.current_stream().cuda_stream),
            "encode3": _host_ms(encode3), "encode3_rc": encode3(),
            "ctypes3": _host_ms(noop3)}


def time_one(fn, match, iters: int) -> dict:
    return {"ms": _events_ms(fn, iters), "device_ms": _device_ms(fn, match),
            "host_ms": _host_ms(fn)}


def run(parent=None, rows=tuple(ROWS), iters: int = 10) -> dict:
    """Check and time this tree's kernel (and ``parent``'s) at each row.
    The result's ``failed`` lists every disagreement with the plain
    version."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ref
    mods = {"this": fa}
    if parent is not None:
        t0 = time.perf_counter()
        mods["parent"] = build_parent(parent)
    out = {"card": torch.cuda.get_device_name(0), "rows": {}}
    if parent is not None:
        out.update(build_s=time.perf_counter() - t0,
                   ptxas_parent=mods["parent"].ptxas)
    names = list(mods)
    order = names + names[::-1]
    bad = []
    for i, (B, S, T, H, KH, D, causal) in enumerate(SWEEP):
        Dv = min(D, 128)
        q, k, v, _ = inputs((B, S, T, H, KH, D, Dv, causal), 100 + i)
        want = ref.flash_attention(q, k, v, causal=causal).float()
        for m in names:
            c = check(mods[m], q, k, v, causal, want)
            if not c["ok"]:
                bad.append(f"{m} at {(B, S, T, H, KH, D, causal)}: {c}")
    out["sweep_cases"] = len(SWEEP)
    for r, name in enumerate(rows):
        row = ROWS[name]
        q, k, v, causal = inputs(row, 40 + r)
        want = ref.flash_attention(q, k, v, causal=causal).float()
        res = {"shape": dict(zip("B S T H KH D Dv causal".split(), row)),
               "check": {}, "passes": []}
        for m in names:
            res["check"][m] = check(mods[m], q, k, v, causal, want)
            if not res["check"][m]["ok"]:
                bad.append(f"{m} at {name}: {res['check'][m]}")
        del want
        for m in order:
            fn = (lambda mod=mods[m]: mod.flash_attention(q, k, v,
                                                          causal=causal))
            res["passes"].append({"kernel": m, **time_one(fn, "flash_bf16",
                                                         iters)})
        res["host_parts"] = host_parts(fa, q, k, v, causal)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        B, S, T, H, KH, D, Dv, _ = row

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=H != KH)
        try:
            res["sdpa"] = time_one(sdpa, None, iters)
        except RuntimeError as e:          # no fused backend takes it
            res["sdpa"] = {"error": str(e)[:200]}
        by = {}
        for p in res["passes"]:
            by.setdefault(p["kernel"], []).append(p)
        res["median"] = {m: {key: statistics.median(p[key] for p in ps)
                             for key in ("ms", "device_ms", "host_ms")}
                         for m, ps in by.items()}
        out["rows"][name] = res
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    if bad:
        out["failed"] = bad
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="an unpacked earlier tree whose kernel to time")
    ap.add_argument("--rows", default=",".join(ROWS))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_sched needs a CUDA card")
    res = run(args.parent, args.rows.split(","), args.iters)
    text = json.dumps(res, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    summary = {name: {m: round(t["ms"], 4) for m, t in r["median"].items()}
               for name, r in res["rows"].items()}
    print(json.dumps({"flash_sched": summary, "failed": res.get("failed")}))
    if res.get("failed"):
        raise SystemExit(1)
    return res


if __name__ == "__main__":
    main()
