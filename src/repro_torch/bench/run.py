"""Benchmark harness of the port: one module per paper table or figure (a
port of ``benchmarks/run.py``).

  PYTHONPATH=src python -m repro_torch.bench.run [--only fig8a]
                                                 [--profile rdma_edr | all]
                                                 [--json DIR] [--time]
                                                 [--check] [--device cpu]

Prints ``name,us_per_call,derived`` CSV.  With ``--json DIR``, also writes
a ``BENCH_<figure>.json`` a figure (its rows, the fabric transport's
per-verb message and byte counters where the figure measures them, and
the card's name where it ran on one).  ``DIR`` may not be the repository
root, where the JAX harness keeps its own ``BENCH_*.json`` files.

``--time`` runs each figure's measured hot path through the shared
warmup + median-of-k harness (``bench/timing.py``) and adds a
``measured_s`` dict ({row name: seconds}) to every figure's JSON; a
figure that emits none fails the run.  ``--check`` runs fabric-check
(``repro_torch.fabric.check``: the op-stream lint and the one-sided race
detector) over each figure's gating suites on the same device and embeds
a ``check: {rules_run, violations, targets}`` block; any violation fails
the run.  ``--profile`` selects the network profile(s) the modeled and
planned parts run under (``all`` sweeps the paper's 1GbE -> EDR axis).
Without ``--device`` every figure runs on the card.

:func:`run_figure` is the one-figure entry that ``main`` loops over; a
caller that drives a figure itself (``chip_smoke.py``) calls it so that
the figure's JSON comes from the same code.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from pathlib import Path

import torch

from repro_torch._bits import resolve_device
from repro_torch.bench import (fig2_microbench, fig6_rsi, fig7_costmodel,
                               fig8a_joins, fig8b_agg, fig9_ml,
                               fig10_contention, fig_scale, fig_serve)
from repro_torch.fabric import netsim

MODULES = {
    "fig2": fig2_microbench,
    "fig6": fig6_rsi,
    "fig7": fig7_costmodel,
    "fig8a": fig8a_joins,
    "fig8b": fig8b_agg,
    "fig9": fig9_ml,
    "fig10": fig10_contention,
    "fig_scale": fig_scale,
    "fig_serve": fig_serve,
}
REPO_ROOT = Path(__file__).resolve().parents[3]


def _figure_key(name: str):
    """Numeric figure order: fig2 ... fig9, fig10, then the unnumbered
    figures like fig_scale (not lexicographic)."""
    digits = "".join(c for c in name if c.isdigit())
    return (int(digits) if digits else 99, name)


def _entry(mod):
    """A module's figure in the harness's form: ``figure`` where its
    ``run`` means something else (Fig 8a, 8b), else ``run``."""
    return getattr(mod, "figure", None) or mod.run


def _run_module(mod, profiles, timed, device, **kw):
    """The figure's (rows, extras); under ``timed`` extras must hold a
    ``measured_s``."""
    rows, extras = _entry(mod)(profiles=profiles, timed=timed,
                               device=device, **kw)
    if timed and not extras.get("measured_s"):
        raise RuntimeError(f"{mod.__name__} emitted no measured_s under "
                           "--time")
    return rows, extras


def json_dir(path) -> Path:
    """``path`` resolved, refused if it is the repository root."""
    out = Path(path).resolve()
    if out == REPO_ROOT:
        raise ValueError(f"--json {path} is the repository root, where the "
                         "JAX harness keeps its BENCH_*.json files; name "
                         "another directory")
    return out


def run_figure(name: str, *, profiles=None, timed: bool = False,
               check: bool = False, device=None, json_to=None,
               profile_label: str = "default", around=None,
               out=None, **kw) -> dict:
    """Run one figure, print its CSV rows to ``out`` (stdout), and return
    its ``BENCH_<name>.json`` payload, also written into ``json_to`` if
    given.  ``around(name)``, if given, makes a context manager entered
    around the figure's own run (not its check).  ``kw`` goes to the
    figure.  Raises if the figure fails; a check's violations are in the
    payload's ``check`` block."""
    out = out or sys.stdout
    dev = resolve_device(device)
    with (around(name) if around else contextlib.nullcontext()):
        rows, extras = _run_module(MODULES[name], profiles, timed, dev,
                                   **kw)
    if check:
        from repro_torch.fabric import check as fabric_check
        summ = fabric_check.summarize(fabric_check.check_figure(name, dev))
        extras["check"] = {"rules_run": summ["rules_run"],
                           "violations": summ["violations"],
                           "targets": summ["targets"]}
        status = "clean" if summ["ok"] else \
            f"{len(summ['violations'])} violation(s)"
        print(f"{name}/fabriccheck: {len(summ['targets'])} targets, "
              f"{status}", file=sys.stderr)
    for row, us, derived in rows:
        print(f"{row},{us:.2f},{derived}", file=out)
    for row, s in sorted(extras.get("measured_s", {}).items()):
        print(f"{row}/measured,{s * 1e6:.2f},median_wallclock", file=out)
    payload = {"figure": name, "profile": profile_label, "timed": timed,
               "rows": [{"name": row, "us_per_call": us,
                         "derived": derived} for row, us, derived in rows],
               **extras}
    if dev.type == "cuda":
        payload["card"] = torch.cuda.get_device_name(dev)
    if json_to is not None:
        path = json_dir(json_to) / f"BENCH_{name}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        print(f"wrote {path}", file=sys.stderr)
    return payload


def main(argv=None, *, around=None) -> int:
    """The command line; ``around`` as :func:`run_figure`'s."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", "--figure", dest="only", default=None,
                    metavar="FIGURE",
                    help="run one figure (--figure is an alias; see --list)")
    ap.add_argument("--list", action="store_true",
                    help="list the registered figures and exit")
    ap.add_argument("--profile", default=None,
                    metavar="NAME|all",
                    help="network profile preset(s): one of "
                         f"{sorted(netsim.PROFILES)}, a legacy key "
                         f"({sorted(netsim.ALIASES)}), or 'all' to sweep "
                         "the whole axis (default: each figure's own)")
    ap.add_argument("--json", default=None, metavar="DIR",
                    help="write BENCH_<figure>.json result files here "
                         "(not the repository root)")
    ap.add_argument("--time", action="store_true",
                    help="measure wall-clock (warmup + median-of-k, the "
                         "device synchronized) and emit measured_s per "
                         "figure")
    ap.add_argument("--check", action="store_true",
                    help="run fabric-check over each figure's gating "
                         "suites and embed a check: {rules_run, "
                         "violations, targets} block in the JSON")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.list:
        for name in sorted(MODULES, key=_figure_key):
            doc = (MODULES[name].__doc__ or "").strip().splitlines()[0]
            print(f"{name:<7} {doc}")
        return 0
    if args.only is not None and args.only not in MODULES:
        ap.error(f"unknown figure {args.only!r} — valid figures: "
                 f"{', '.join(sorted(MODULES, key=_figure_key))}")
    if args.json:
        os.makedirs(json_dir(args.json), exist_ok=True)
    dev = resolve_device(args.device)
    if args.profile is None:
        profiles = None                       # each figure's default
    elif args.profile == "all":
        profiles = tuple(netsim.PROFILES)
    else:
        profiles = (netsim.get_profile(args.profile).name,)
    names = [args.only] if args.only else sorted(MODULES, key=_figure_key)
    print("name,us_per_call,derived")
    failed = []
    for name in names:
        try:
            payload = run_figure(name, profiles=profiles, timed=args.time,
                                 check=args.check, device=dev,
                                 json_to=args.json,
                                 profile_label=args.profile or "default",
                                 around=around)
        except Exception as e:  # noqa: BLE001
            failed.append((name, e))
            print(f"{name}/ERROR,0,{type(e).__name__}:{e}", file=sys.stderr)
            continue
        if payload.get("check", {}).get("violations"):
            failed.append((name, RuntimeError("fabriccheck violations")))
    if failed:
        raise SystemExit(f"benchmarks failed: {[n for n, _ in failed]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
