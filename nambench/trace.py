"""The traced slice: a few units under ``torch.profiler``, reduced to
summaries (no trace is written).

The profiler runs one unit as its warm-up, unrecorded (a fresh trace can
miss the first kernels it sees), then records ``units`` units.  From the
device's operations come the busy seconds (the union of their intervals),
the seconds by operation name, and the idle gaps between them, each named
after the innermost host operation or benchmark span that covers it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch
from torch.profiler import ProfilerActivity, profile, schedule

SPAN_PREFIX = "nambench."     # the benchmark's own spans (record_function)


def short_name(name: str) -> str:
    """A device operation's name without its return type, namespace,
    template and argument lists (``bench/profile_commit.py``'s rule)."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in ("(", "<"):
        name = name.split(stop, 1)[0]
    return name.strip().split("::")[-1]


@dataclass
class Slice:
    """What the traced slice left: its units' records, its host-clock
    length, and the device's operations as (name, start_us, end_us)."""
    units: list
    window_s: float
    device_ops: list
    host_ops: list          # (name, start_us, end_us)

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (their union)."""
        total, end = 0.0, None
        for _, s, e in sorted(self.device_ops, key=lambda o: o[1]):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e6

    def device_s(self, names=None) -> float:
        """Summed seconds of the device operations (of ``names`` only,
        if given)."""
        keep = None if names is None else set(names)
        return sum(e - s for n, s, e in self.device_ops
                   if keep is None or n in keep) / 1e6

    def by_name(self, top: int = 10) -> list:
        acc: dict = {}
        for n, s, e in self.device_ops:
            acc[n] = acc.get(n, 0.0) + (e - s) / 1e6
        return sorted(acc.items(), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle seconds between device operations, summed by the innermost
        host operation that covers each gap's middle."""
        ops = sorted(self.device_ops, key=lambda o: o[1])
        gaps, end = [], None
        for _, s, e in ops:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        # one sweep: host operations open on a stack (they nest), each
        # gap's middle read off the innermost one still open
        host = sorted(self.host_ops, key=lambda o: (o[1], -o[2]))
        acc: dict = {}
        stack, i = [], 0
        for mid, a, b in sorted(((a + b) / 2, a, b) for a, b in gaps):
            while i < len(host) and host[i][1] <= mid:
                while stack and stack[-1][2] < host[i][1]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            label = stack[-1][0] if stack else "host (no traced op)"
            acc[label] = acc.get(label, 0.0) + (b - a) / 1e6
        return sorted(acc.items(), key=lambda kv: -kv[1])[:top]


def traced(unit, units: int, device) -> Slice:
    """Run ``unit()`` 1 + ``units`` times under the profiler, the first as
    its warm-up; returns the recorded slice."""
    records = []
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=units,
                                   repeat=1)) as prof:
        unit()
        torch.cuda.synchronize(device)
        prof.step()
        t0 = time.perf_counter()
        for _ in range(units):
            records.append(unit())
            torch.cuda.synchronize(device)
            prof.step()
        window_s = time.perf_counter() - t0
    dev_ops, host_ops = [], []
    for e in prof.events():
        s = e.time_range.start
        t = e.time_range.end
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        # a step's range, and a benchmark span's mirror on the device's
        # timeline, are ranges, not operations: counting them would count
        # the work twice
        if e.name.startswith("ProfilerStep") or (
                on_device and e.name.startswith(SPAN_PREFIX)):
            continue
        if on_device:
            dev_ops.append((short_name(e.name), s, t))
        else:
            host_ops.append((e.name, s, t))
    return Slice(records, window_s, dev_ops, host_ops)
