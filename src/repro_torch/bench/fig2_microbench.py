"""Fig 2/3 surrogate: network throughput/latency + CPU overhead curves (a
port of ``benchmarks/fig2_microbench.py``).

Real NICs are absent; the InfiniBand/Ethernet side comes from the paper's
calibrated ``NetworkProfile`` presets (``repro_torch.fabric.netsim``: the
§3 microbenchmark numbers as data).  What is measured, on the card: the
local memory-bandwidth constant c_mem (the paper's comparison baseline,
``a + 1.0`` over 1, 16 and 64 MB of f32) and the per-op dispatch overhead
of the one-sided verbs (the 450-cycle analogue): a READ of 256 rows of a
(65 536, 16) f32 region, a CAS and a FETCH_ADD of 256 requests on 65 536
words (the CAS runs the ``cas_lock`` kernel through ``fabric.verbs.cas``)
and one 2-field route of 65 536 requests into one bucket (the rank and
scatter kernels of ``radix_partition``).  The verbs work in place, so a
repeated CAS finds its words locked and fails: the kernel compares every
request all the same.  The modeled rows sweep the profile axis:
per-message latency (setup + per-message + wire) and the effective
bandwidth it implies per message size, the shape of the paper's Fig 2
curves.

    PYTHONPATH=src python -m repro_torch.bench.run --only fig2 [--device cpu]
"""
import time

import torch

from repro_torch._bits import resolve_device
from repro_torch.bench import timing
from repro_torch.fabric import LocalTransport, netsim, verbs

DEFAULT_PROFILES = tuple(netsim.PROFILES)       # fig2 IS the axis figure
COPY_MB = (1, 16, 64)
REGION_ROWS, REGION_WIDTH, REQS = 1 << 16, 16, 256
ROUTE_REQS = 1 << 16
MESSAGE_SIZES = (8, 256, 2048, 32768, 1 << 20)


def _timeit(f, *args, n=5, device=None):
    """The JAX benchmark's untimed form: one warm-up call, then the mean
    of ``n`` back-to-back calls with one synchronize after them (us)."""
    f(*args)
    timing.sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        f(*args)
    timing.sync(device)
    return (time.perf_counter() - t0) / n * 1e6


def route_64k(transport, ks):
    """One 2-field route of ``ks`` (int32 bit patterns) into bucket
    ``ks % 1`` = 0, cap 65 536: the motion every protocol stands on."""
    return transport.route({"k": ks, "v": ks}, torch.remainder(ks, 1),
                           cap=ROUTE_REQS).fields["k"]


def modeled_rows(profiles) -> list:
    """Per-message latency and bandwidth a message size and profile (Fig
    2), CPU cycles a message (Fig 3) and NIC rate caps (Fig 4)."""
    rows = []
    for size in MESSAGE_SIZES:
        for name in profiles:
            p = netsim.get_profile(name)
            lat_us = p.t_call(1, size) * 1e6
            rows.append((f"fig2/model_latency_{name}_{size}B", lat_us,
                         f"{size / (lat_us / 1e6) / 1e9:.2f}GB/s_"
                         f"{p.bound(1, size)}_bound"))
    for name in profiles:
        p = netsim.get_profile(name)
        rows.append((f"fig3/model_cpu_cycles_{name}", 0.0,
                     f"{int(p.cycles_per_msg)}cycles"))
        rows.append((f"fig4/model_msg_rate_{name}",
                     p.msg_rate / 1e6, "Mmsgs/s"))
    return rows


def run(profiles=None, timed=False, *, device=None):
    profiles = tuple(profiles) if profiles else DEFAULT_PROFILES
    dev = resolve_device(device)
    rows = []
    measured = {}

    def measure(name, f, *args):
        """One measured row; with --time, the shared warmup+median-of-k
        harness also records measured_s."""
        if timed:
            s = timing.device_time_s(f, *args, device=dev)
            measured[name] = s
            return s * 1e6
        return _timeit(f, *args, device=dev)

    # measured: local memory copy bandwidth (c_mem calibration)
    for mb in COPY_MB:
        x = torch.ones((mb * 1024 * 1024 // 4,), dtype=torch.float32,
                       device=dev)
        us = measure(f"fig2/mem_copy_{mb}MB", lambda a: a + 1.0, x)
        bw = mb / (us / 1e6) / 1024  # GB/s
        rows.append((f"fig2/mem_copy_{mb}MB", us, f"{bw:.1f}GB/s"))
        del x
    # measured: one-sided op dispatch overhead on a NAM region (the CAS
    # and the FETCH_ADD each on words of their own: they work in place)
    region = torch.zeros((REGION_ROWS, REGION_WIDTH), dtype=torch.float32,
                         device=dev)
    cas_words, fa_words = (torch.zeros((REGION_ROWS,), dtype=torch.int32,
                                       device=dev) for _ in range(2))
    idx = torch.arange(REQS, dtype=torch.int32, device=dev)
    zeros = torch.zeros((REQS,), dtype=torch.int32, device=dev)
    ones = torch.ones((REQS,), dtype=torch.int32, device=dev)
    rows.append(("fig2/fabric_read_256rows",
                 measure("fig2/fabric_read_256rows", verbs.read,
                         region, idx), ""))
    rows.append(("fig2/fabric_cas_256reqs",
                 measure("fig2/fabric_cas_256reqs", verbs.cas,
                         cas_words, idx, zeros, ones), ""))
    rows.append(("fig2/fabric_fetch_add_256reqs",
                 measure("fig2/fabric_fetch_add_256reqs", verbs.fetch_add,
                         fa_words, idx, ones), ""))
    # measured: the packed router itself, one 64K-request 2-field route
    tp = LocalTransport(device=dev)
    ks = torch.arange(ROUTE_REQS, dtype=torch.int32, device=dev)
    rows.append(("fig2/fabric_route_64Kreqs",
                 measure("fig2/fabric_route_64Kreqs",
                         lambda k: route_64k(tp, k), ks), ""))
    rows += modeled_rows(profiles)
    extras = {"profiles": {n: vars(netsim.get_profile(n))
                           for n in profiles}}
    if timed:
        extras["measured_s"] = measured
    return rows, extras
