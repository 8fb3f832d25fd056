"""One run of one cell: set-up, the measured window, the traced slice
(``--trace 1``), the comparison with the reference, the result line.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared, with its
limit); the same checks are the last lines of standard error.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import os
import sys
import time
from types import SimpleNamespace

from nambench import roofline
from nambench.spec import Spec

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def process_start() -> float:
    """``time.perf_counter()`` at this process's start, from
    ``/proc/self/stat`` and ``/proc/uptime`` (10 ms ticks); the time of
    this module's import where those cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        age = -1.0
    now = time.perf_counter()
    return now - age if 0 <= age < 600 else _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's, the JAX
    package's or its benchmarks' (whole names: ``repro_torch`` is not
    ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Refused(RuntimeError):
    """A run that must print no result (exit code 2)."""


def run_cell(spec: Spec, workload: str, seed: int, seconds: float,
             trace: bool, *, device=None, planted=None,
             started: float | None = None) -> dict:
    """Run one cell once.  ``device=None`` takes the card and refuses to
    run without one (or with fewer than the cell asks for); tests pass a
    CPU device.  ``planted`` is a context manager entered around set-up,
    window and check (``faults.py``).  Returns the result, with
    ``checks`` as (name, value, limit) triples."""
    import torch
    started = process_start() if started is None else started
    cell = spec.cell(workload)
    if device is None:
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"{torch.cuda.device_count()} card(s), the cell "
                          f"asks for {cell.chips}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    if trace and not on_card:
        raise ValueError("a traced run needs the card")
    config = spec.config(cell.config)
    traffic = spec.traffic(cell.traffic)
    kind = importlib.import_module(f"nambench.kinds.{traffic['kind']}")
    built = {}
    if on_card:
        from repro_torch.kernels import build
        built = {k: bool(v) for k, v in
                 build.build(tuple(config["kernels"])).items()}
        torch.cuda.init()
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats()
    with (planted or contextlib.nullcontext()):
        st = kind.setup(config, traffic, seed, device)
        if on_card:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        setup_s = t0 - started
        units = []
        while True:
            units.append(kind.unit(st))
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        sliced = None
        if trace:
            from nambench import trace as tracing
            sliced = tracing.traced(lambda: kind.unit(st),
                                    int(traffic["trace_units"]), device)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        checks = kind.check(st)
    del st
    ctx = SimpleNamespace(setup_s=setup_s, window_s=window_s, units=units,
                          trace=sliced, roofline=roofline, spec=spec,
                          cell=cell, config=config, traffic=traffic)
    metrics = {}
    wanted = spec.per_layer_of(cell.name) if trace else \
        spec.end_to_end_of(cell.name)
    for m in wanted:
        ctx.metric = m.name
        value = spec.reader(m.name)(ctx)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m.name} read "
                                   "nothing")
            continue
        metrics[m.name] = {"value": float(value), "unit": m.unit}
    result = {
        "correct": all(v <= lim for _, v, lim in checks),
        "attempted": sum(u["attempted"] for u in units),
        "failed": sum(u["failed"] for u in units),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else device.type,
                   "kind": (torch.cuda.get_device_name(device)
                            if on_card else "cpu"),
                   "count": cell.chips,
                   "memory_peak_bytes": int(peak)},
        "kernels_built": [k for k, v in built.items() if v],
    }
    if sliced is not None:
        result["device"]["busy_s"] = sliced.busy_s()
        result["device"]["window_s"] = sliced.window_s
        result["breakdown"] = {"device_ops": sliced.by_name(10),
                               "idle_gaps": sliced.idle_gaps(10)}
    result["checks"] = checks
    return result


def checks_text(checks) -> list:
    return [f"check {name}: {value} (limit {limit})"
            for name, value, limit in checks]


def main(argv=None) -> int:
    import argparse
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = Spec()
    try:
        result = run_cell(spec, args.workload, args.seed, args.seconds,
                          bool(args.trace), started=started)
    except Refused as e:
        print(f"nambench: refused: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"nambench: the run loaded {', '.join(bad)}: no result",
              file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    print(json.dumps(result), flush=True)
    print("\n".join(checks_text(checks)), file=sys.stderr, flush=True)
    return 0
