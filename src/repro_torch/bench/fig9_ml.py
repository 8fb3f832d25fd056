"""Fig 9 in the port (§6): distributed ML, synchronous all-reduce against
the bounded-stale NAM parameter server under injected straggler skew.

The counterpart of ``benchmarks/fig9_ml.py``, at its sizes: four
workers, worker 0 four times slower, 48 batches of a {"w": (256, 64),
"b": (64,)} model.  Compute time is a virtual clock; every fabric
operation runs for real through a counted ``LocalTransport``, and each
mode's measured per-verb counters are priced with the network profile
(``t_net`` + ``t_msgs``) beside the §6 cost model's prediction:

  * **sync all-reduce**: a barrier every step (the slowest worker) and
    one counted ``psum`` of the raw f32 gradient;
  * **paramserver(k)**, k in {0, 8}: workers claim batches off a shared
    FETCH_ADD ticket counter (``core.workqueue.claim_ticket_ranges``),
    pull through the staleness gate and push int8-compressed gradients
    through ``route()``; fast workers claim more tickets.

The parameters and gradients are drawn with numpy (``_params``,
``_grad``); ``run(params=, grad=)`` takes others, so the tests feed the
JAX benchmark's arrays to both packages and compare every row.
``timed=True`` also times one PS round (a pull and a push) on the
device, as the reference's ``run(timed=True)`` does.

    PYTHONPATH=src python -m repro_torch.bench.fig9_ml [--device cpu] [--timed]
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from repro_torch._bits import resolve_device, u32
from repro_torch.analytics import DEFAULT_SHARDS, ParameterServer
from repro_torch.core import costmodel, workqueue
from repro_torch.fabric import LocalTransport, netsim
from repro_torch.train import grad_compress as gc
from repro_torch.tree import ravel

WORKERS = 4
STRAGGLER_FACTOR = 4.0          # worker 0 is 4x slower
BASE_COMPUTE_S = 10e-3          # virtual per-batch compute time
TOTAL_BATCHES = 48
DEFAULT_PROFILES = ("rdma_fdr4x",)
PARAM_SHAPE = {"w": (256, 64), "b": (64,)}
TIMED_ROUNDS = 20


def _params() -> dict:
    rng = np.random.default_rng(0)
    return {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
            for k, s in sorted(PARAM_SHAPE.items())}


def _grad(ticket: int) -> dict:
    rng = np.random.default_rng([1, ticket])
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in sorted(PARAM_SHAPE.items())}


def _tensors(tree: dict, dev) -> dict:
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
            for k, v in tree.items()}


def _delta(transport, before: dict) -> dict:
    out = {}
    for verb, s in transport.stats().items():
        b = before.get(verb, {"calls": 0, "msgs": 0, "bytes": 0})
        d = {k: s[k] - b.get(k, 0) for k in ("calls", "msgs", "bytes")}
        if any(d.values()):
            out[verb] = d
    return out


def _run_sync(compute_s, prof, grad, dev):
    """Barrier per step: everyone waits for the slowest, then all-reduces
    the raw f32 gradient (one counted psum per step)."""
    transport = LocalTransport(device=dev)
    wall = 0.0
    for step in range(TOTAL_BATCHES // WORKERS):
        flat = ravel(_tensors(grad(step), dev))[0]
        before = transport.stats()
        transport.psum(flat)                    # the all-reduce wire
        nbytes = sum(v["bytes"] for v in _delta(transport, before).values())
        # ring all-reduce: 2(W-1)/W of the counted bytes in 2(W-1)
        # messages (what t_allreduce prices), plus one setup
        wall += (max(compute_s) + prof.setup_s
                 + costmodel.t_net(2 * (WORKERS - 1) / WORKERS * nbytes,
                                   prof)
                 + costmodel.t_msgs(2 * (WORKERS - 1), prof))
    return wall, transport.stats()


def _run_ps(compute_s, staleness: int, prof, params, grad, dev):
    """Each worker claims tickets off the shared FETCH_ADD head counter as
    soon as it is free (an event loop on the virtual clock, whose wire
    share comes from the network profile)."""
    transport = LocalTransport(device=dev)
    ps = ParameterServer(_tensors(params, dev), transport=transport,
                         staleness=staleness, block=256)
    head = torch.zeros((1,), dtype=torch.int32, device=dev)
    one = torch.ones((1,), dtype=torch.int32, device=dev)
    clock = [0.0] * WORKERS
    done = 0
    while done < TOTAL_BATCHES:
        w = min(range(WORKERS), key=clock.__getitem__)
        before = transport.stats()
        starts, head = workqueue.claim_ticket_ranges(head, one,
                                                     transport=transport)
        ticket = int(u32(starts[0]))
        if ticket >= TOTAL_BATCHES:
            break
        ps.pull(worker=w)                       # bounded-stale READ
        ps.push(_tensors(grad(ticket), dev), worker=w)
        clock[w] += compute_s[w] + prof.modeled_time(
            _delta(transport, before))
        done += 1
    return max(clock), transport.stats()


def _run_one_profile(pname, compute_s, rows, prefix, params, grad, dev):
    prof = netsim.get_profile(pname)
    sync_wall, sync_stats = _run_sync(compute_s, prof, grad, dev)
    rows.append((f"fig9/{prefix}sync_allreduce_wallclock", sync_wall * 1e6,
                 f"steps{TOTAL_BATCHES // WORKERS}_"
                 f"straggler{STRAGGLER_FACTOR:g}x"))
    comp_bytes, raw_bytes = gc.wire_bytes(_tensors(params, "cpu"))
    ps_stats, ps_walls = {}, {}
    for k in (0, 8):
        wall, stats = _run_ps(compute_s, k, prof, params, grad, dev)
        ps_walls[k], ps_stats[f"ps_k{k}"] = wall, stats
        speedup = sync_wall / wall
        beats = "beats_sync" if wall < sync_wall else "SLOWER_than_sync"
        rows.append((f"fig9/{prefix}ps_k{k}_wallclock", wall * 1e6,
                     f"{beats}_x{speedup:.2f}"))
        pull_bytes = stats.get("read", {}).get("bytes", 0)
        push_bytes = stats.get("route", {}).get("bytes", 0)
        rows.append((f"fig9/{prefix}ps_k{k}_push_bytes", float(push_bytes),
                     f"compressed_vs_f32_{raw_bytes * TOTAL_BATCHES}"))
        rows.append((f"fig9/{prefix}ps_k{k}_pull_bytes", float(pull_bytes),
                     "staleness_gated"))
    # §6 cost model prediction next to the measured economics
    model = {
        "t_allreduce_s": costmodel.t_allreduce(raw_bytes, WORKERS, prof),
        "t_ps_step_k0_s": costmodel.t_ps_step(
            raw_bytes, DEFAULT_SHARDS, prof, staleness=0, workers=WORKERS,
            compress_ratio=comp_bytes / raw_bytes),
        "t_ps_step_k8_s": costmodel.t_ps_step(
            raw_bytes, DEFAULT_SHARDS, prof, staleness=8, workers=WORKERS,
            compress_ratio=comp_bytes / raw_bytes),
    }
    rows.append((f"fig9/{prefix}model_t_allreduce",
                 model["t_allreduce_s"] * 1e6, "per_step"))
    rows.append((f"fig9/{prefix}model_t_ps_step_k8",
                 model["t_ps_step_k8_s"] * 1e6, "per_step"))
    return {"fabric": ps_stats, "sync_fabric": sync_stats, "model": model,
            "grad_bytes_f32": raw_bytes,
            "grad_bytes_compressed": comp_bytes,
            "wallclock_s": {"sync": sync_wall,
                            **{f"ps_k{k}": w for k, w in ps_walls.items()}}}


def round_s(ps, grad, dev) -> float:
    """Median seconds of one PS round (a pull and a push), each
    synchronized on the device, after one warm-up round."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    times = []
    for i in range(TIMED_ROUNDS + 1):
        sync()
        t0 = time.perf_counter()
        ps.pull(worker=0)
        ps.push(grad, worker=0)
        sync()
        if i:
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def run(profiles=None, timed=False, *, device=None, params=None, grad=None):
    """(rows, extras) as the JAX benchmark's ``run``.  ``params``: a tree of
    numpy arrays; ``grad(ticket)``: a tree per ticket (both numpy draws by
    default)."""
    dev = resolve_device(device)
    params = params if params is not None else _params()
    grad = grad or _grad
    profiles = tuple(profiles) if profiles else DEFAULT_PROFILES
    rows = []
    compute_s = [BASE_COMPUTE_S] * WORKERS
    compute_s[0] *= STRAGGLER_FACTOR
    per_profile = {}
    for pname in profiles:
        prefix = f"{pname}_" if len(profiles) > 1 else ""
        per_profile[pname] = _run_one_profile(pname, compute_s, rows,
                                              prefix, params, grad, dev)
    extras = {"workers": WORKERS, "straggler_factor": STRAGGLER_FACTOR,
              "total_batches": TOTAL_BATCHES}
    if len(profiles) == 1:
        extras.update(per_profile[profiles[0]])
        extras["profile"] = profiles[0]
    else:
        extras["profiles"] = per_profile
    if timed:
        # the figure's wall-clocks are event-loop simulations; the device
        # work per step is the PS round trip, measured here
        ps = ParameterServer(_tensors(params, dev),
                             transport=LocalTransport(device=dev),
                             staleness=8, block=256)
        extras["measured_s"] = {"fig9/ps_pull_push_round": round_s(
            ps, _tensors(grad(0), dev), dev)}
        extras["device"] = (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu")
    return rows, extras


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--profiles", default=None,
                    help="comma-separated network profiles")
    ap.add_argument("--timed", action="store_true")
    args = ap.parse_args(argv)
    rows, extras = run(args.profiles.split(",") if args.profiles else None,
                       timed=args.timed, device=args.device)
    for name, val, derived in rows:
        print(f"{name},{val},{derived}")
    print(json.dumps({k: extras[k] for k in extras
                      if k in ("wallclock_s", "measured_s", "device")}))


if __name__ == "__main__":
    main()
