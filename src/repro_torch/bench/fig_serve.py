"""fig_serve in the port: continuous-batching per-token latency over
two-tier KV paging, p50/p99 per network profile, sweeping the hot-tier
fraction.

The counterpart of ``benchmarks/fig_serve.py``.  One seeded workload
(sustained request arrival), six engine configurations, one real
paged-decode run each through a traced ``LocalTransport``; every trace is
then re-priced on the profile axis by :func:`repro_torch.fabric.sim.replay`.
Async configurations replay at window 2 (wave *i*'s decode compute
overlaps wave *i+1*'s prefetched cold READs), blocking ones at window 1.
Per-token latency is the gap series of the per-round ``compute`` events
(:func:`repro_torch.fabric.sim.completion_gaps`).

Asserted, as in the JAX benchmark:

(a) **async beats blocking**: with the same 25 % hot tier, the async
    per-token p99 is strictly below the blocking p99 on every RDMA
    profile;
(b) **a small hot tier recovers the all-local baseline**: the modeled
    makespan penalty over all-local shrinks >= 2x from the all-cold
    configuration (1 hot block) to the 25 % hot tier, on every RDMA
    profile;
(c) **paging parity**: every configuration decodes the all-local tokens.

:func:`run` takes ``small=True`` for the JAX benchmark's short workload
(its ``FIG_SERVE_SMALL``) and ``device=`` (the card unless the caller
asks for the CPU).  The traces equal the JAX benchmark's event for event:
they count requests, blocks and rounds, never token values.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch._bits import resolve_device
from repro_torch.configs import get_config, reduce_config
from repro_torch.db import Database
from repro_torch.fabric import LocalTransport, netsim, sim
from repro_torch.models import api
from repro_torch.serving import Request, ServeEngine

DEFAULT_PROFILES = ("ethernet_1g", "ipoib_fdr", "rdma_fdr4x", "rdma_edr")
SEED = 11
SLOTS = 2                 # dense decode slots (the wave width)
BLOCK_TOKENS = 8
DECODE_COMPUTE_S = 5e-6   # modeled per-round decode compute (emit_compute)

#: hot-tier fractions swept by the async configurations; "all_cold" pins
#: the hot tier to one block and "all_local" to the whole capacity.
HOT_SWEEP = (0.5, 0.25, 0.125)
FULL = dict(n=12, max_arrival=24, new=(8, 15),
            shape=dict(max_seq=256, max_resident=8, capacity=128))
SMALL = dict(n=6, max_arrival=12, new=(6, 10),
             shape=dict(max_seq=160, max_resident=4, capacity=32))


def workload(n, max_arrival, new_lo, new_hi, *, seed=SEED):
    """Seeded sustained arrivals: request ``i`` enters the queue at a
    uniform tick in [0, max_arrival) with a 2-5 token prompt and a
    [new_lo, new_hi) decode budget (the JAX benchmark's draws)."""
    rng = np.random.default_rng(seed)
    arrivals = []
    for i in range(n):
        plen = int(rng.integers(2, 6))
        arrivals.append((int(rng.integers(0, max_arrival)), i,
                         rng.integers(2, 30, size=plen).astype(np.int32),
                         int(rng.integers(new_lo, new_hi))))
    arrivals.sort(key=lambda a: (a[0], a[1]))
    return arrivals


def record(cfg, params, wl, *, max_seq, max_resident, capacity, **kw):
    """One real paged-decode run of the workload through a traced
    transport on the parameters' device; returns the trace, its compute
    event seqs, the outputs and every counter surface the run touched."""
    tracer = sim.EventTracer()
    db = Database(LocalTransport(tracer=tracer,
                                 device=params["embed"].device))
    eng = ServeEngine(cfg, params, slots=SLOTS, max_seq=max_seq,
                      paged=True, block_tokens=BLOCK_TOKENS,
                      max_resident=max_resident, capacity_blocks=capacity,
                      db=db, decode_compute_s=DECODE_COMPUTE_S, **kw)
    t0 = time.perf_counter()
    tick, i, done = 0, 0, []
    while i < len(wl) or eng.waiting or eng.resident:
        while i < len(wl) and wl[i][0] <= tick:
            _, rid, prompt, new = wl[i]
            eng.enqueue(Request(rid=rid, prompt=prompt,
                                max_new_tokens=new))
            i += 1
        done += eng.tick()
        tick += 1
    eng.quiesce()
    wall = time.perf_counter() - t0
    if bool(eng.slot_words.any()):
        raise AssertionError("slots leaked")
    comp = [e.seq for e in tracer.events if e.verb == "compute"]
    return {"trace": tracer.events, "compute_seqs": comp,
            "outs": {r.rid: tuple(r.out) for r in done},
            "store": eng.store.stats(),
            "counters": dict(eng.store.counters),
            "fabric": db.fabric_stats(), "wall_s": wall,
            "rounds": len(comp), "ticks": tick,
            "tokens": sum(len(r.out) for r in done)}


def price(rec, profile, *, window):
    """Replay one recorded serve trace on ``profile`` and take the
    per-token latency distribution over its decode rounds."""
    res = sim.replay(rec["trace"], profile, nodes=2, window=window)
    gaps = sim.completion_gaps(res, rec["compute_seqs"])
    return {"makespan_s": res.makespan,
            "p50_s": sim.percentile(gaps, 0.50),
            "p99_s": sim.percentile(gaps, 0.99),
            "tokens_per_s": rec["tokens"] / res.makespan}


def _device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def model(device=None):
    """The JAX benchmark's model: ``reduce_config(glm4-9b)``, f32
    parameters from seed 0, on ``device``."""
    cfg = reduce_config(get_config("glm4-9b"))
    return cfg, api.init_params(cfg, device=resolve_device(device))


def run(profiles=None, timed=False, *, small: bool = False, device=None):
    """The figure: (rows, extras) as the JAX benchmark returns them."""
    profiles = tuple(profiles) if profiles else DEFAULT_PROFILES
    size = SMALL if small else FULL
    wl = workload(size["n"], size["max_arrival"], *size["new"])
    shape = size["shape"]
    cfg, params = model(device)

    # ------------------------------------------- record (once, real) ----
    sweep = (0.25,) if small else HOT_SWEEP
    configs = {"all_local": dict(hot_frac=1.0)}
    for frac in sweep:
        configs[f"hot{frac:g}"] = dict(hot_frac=frac)
    configs["hot0.25_blocking"] = dict(hot_frac=0.25, prefetch=False)
    configs["all_cold"] = dict(hot_blocks=1)
    recs = {name: record(cfg, params, wl, **shape, **kw)
            for name, kw in configs.items()}

    # acceptance (c): residency never changes bits
    baseline = recs["all_local"]["outs"]
    for name, rec in recs.items():
        if rec["outs"] != baseline:
            raise AssertionError(f"{name}: decode output diverged")
    # the <= 25 % hot tiers must page: cold READs happened and dirty
    # evictions wrote back
    for name in (f"hot{f:g}" for f in sweep if f <= 0.25):
        c = recs[name]["counters"]
        if c["misses"] + c["prefetched"] <= 0:
            raise AssertionError(f"{name}: no cold reads")
        if c["writebacks"] <= 0:
            raise AssertionError(f"{name}: no dirty write-backs")

    # ------------------------------------- price (per profile, sim) ----
    rows, latency, recovery = [], {}, {}
    for pname in profiles:
        prof = netsim.get_profile(pname)
        pts = {}
        for name, rec in recs.items():
            # blocking host loop: every verb serializes (window 1);
            # async: issue -> overlap -> wait (window 2)
            window = 1 if "blocking" in name else 2
            pts[name] = price(rec, prof, window=window)
            rows.append((f"fig_serve/{pname}_{name}",
                         pts[name]["p99_s"] * 1e6,
                         f"p50_{pts[name]['p50_s'] * 1e6:.2f}us"
                         f"_{pts[name]['tokens_per_s']:,.0f}tok/s"))
        latency[pname] = pts
        # acceptance (a): same hot tier, async strictly under blocking
        a_p99 = pts["hot0.25"]["p99_s"]
        b_p99 = pts["hot0.25_blocking"]["p99_s"]
        if prof.rdma and not a_p99 < b_p99:
            raise AssertionError(f"{pname}: async p99 {a_p99:.3e} not "
                                 f"below blocking {b_p99:.3e}")
        # acceptance (b): the makespan penalty over all-local shrinks
        # >= 2x from all-cold to the 25 % hot tier
        base = pts["all_local"]["makespan_s"]
        pen_cold = pts["all_cold"]["makespan_s"] - base
        pen_hot = max(pts["hot0.25"]["makespan_s"] - base, 1e-15)
        recovery[pname] = {"penalty_all_cold_s": pen_cold,
                           "penalty_hot25_s": pen_hot,
                           "ratio": pen_cold / pen_hot}
        if prof.rdma and not pen_cold >= 2.0 * pen_hot:
            raise AssertionError(f"{pname}: 25% hot tier recovers only "
                                 f"{pen_cold / pen_hot:.2f}x over "
                                 "all-cold")
        rows.append((f"fig_serve/{pname}_recovery", 0.0,
                     f"{pen_cold / pen_hot:.1f}x_async_vs_blocking_"
                     f"{b_p99 / a_p99:.2f}x"))

    extras = {
        "workload": {"requests": len(wl), "seed": SEED, "small": small,
                     "slots": SLOTS, "block_tokens": BLOCK_TOKENS,
                     "decode_compute_s": DECODE_COMPUTE_S,
                     "decode_rounds": recs["all_local"]["rounds"],
                     "tokens": recs["all_local"]["tokens"], **shape},
        "parity": True,
        "latency": latency,
        "recovery": recovery,
        "configs": {name: {"counters": rec["counters"],
                           "store": rec["store"],
                           "fabric": rec["fabric"],
                           "trace_events": len(rec["trace"])}
                    for name, rec in recs.items()},
        "device": _device_name(params["embed"].device),
    }
    if timed:
        extras["measured_s"] = {
            f"fig_serve/record_{name}": rec["wall_s"]
            for name, rec in recs.items()}
    return rows, extras


if __name__ == "__main__":
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    rows, extras = run(timed=True, small=args.small, device=args.device)
    for name, us, derived in rows:
        print(f"{name},{us:.3f},{derived}")
    print(json.dumps({k: extras[k] for k in ("workload", "recovery",
                                             "device")}))
