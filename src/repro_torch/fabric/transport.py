"""Transports: where the verbs and the router run, and what they cost.

The port of ``repro.fabric.transport``.  A transport binds the verbs
(:mod:`repro_torch.fabric.verbs`) and the router
(:mod:`repro_torch.fabric.router`) to a device and **counts messages and
bytes per verb** (read / write / cas / fetch_add / route / exchange / psum
/ all_gather) with the JAX transport's keys: ``calls``, ``msgs``,
``bytes``, ``peak_outstanding``, ``queue_hist`` and, with a network
profile bound, ``modeled_s``.  The counts are the same capacity counts:
a route is ``n * chunks`` messages and its bytes are the packed buffer.
``plan_route`` is local compute, counted in ``plan_builds``.

PyTorch runs eagerly, so every call counts.  That equals JAX's transport
under ``Database(jit=False)``; a jitted JAX function counts once, at
trace time.

``recorder=`` and ``tracer=`` take the JAX package's hook objects (a
schedule recorder and an event tracer, ported with the race detector and
the contention simulator); with ``None`` they do nothing.

``device=`` is where the transport's tensors live: the card unless the
caller asks for the CPU (:func:`repro_torch._bits.resolve_device`).
``impl=`` is handed to the kernel dispatch (:mod:`repro_torch.kernels.ops`).
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch._bits import resolve_device
from repro_torch.fabric import netsim
from repro_torch.fabric import router as _router
from repro_torch.fabric import verbs as _verbs


def _row_bytes(arr) -> int:
    return math.prod(arr.shape[1:]) * arr.element_size()


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _depth_bucket(q: int) -> str:
    """Power-of-two queue-depth bucket label: "0", "1-1", "2-3", "4-7"..."""
    if q <= 0:
        return "0"
    lo = 1 << (int(q).bit_length() - 1)
    return f"{lo}-{2 * lo - 1}"


class Transport:
    """Base transport: verb dispatch plus message/byte accounting."""

    axis: Optional[str] = None

    def __init__(self, profile=None, recorder=None, tracer=None, *,
                 device=None, impl=None):
        self.device = resolve_device(device)
        self.impl = impl
        self._stats: dict = {}
        self._local_stats: dict = {}
        self.plan_builds: int = 0
        self.profile = (netsim.get_profile(profile)
                        if profile is not None else None)
        self.recorder = recorder
        self.tracer = tracer

    # ------------------------------------------------------ accounting ---

    def _bump(self, table: dict, verb: str, msgs: int, nbytes: int,
              window: int) -> dict:
        s = table.setdefault(verb, {"calls": 0, "msgs": 0, "bytes": 0})
        s["calls"] += 1
        s["msgs"] += int(msgs)
        s["bytes"] += int(nbytes)
        # how many of this call's requests are in flight at once (the
        # declared window caps it) and how many queued behind the window
        outstanding = min(int(msgs), window) if window else int(msgs)
        s["peak_outstanding"] = max(s.get("peak_outstanding", 0),
                                    outstanding)
        hist = s.setdefault("queue_hist", {})
        b = _depth_bucket(int(msgs) - outstanding)
        hist[b] = hist.get(b, 0) + 1
        return s

    def _count(self, verb: str, msgs: int, nbytes: int, *,
               window: int = 0, collective: bool = False):
        s = self._bump(self._stats, verb, msgs, nbytes, window)
        if self.profile is not None:
            s["modeled_s"] = (s.get("modeled_s", 0.0)
                              + self.profile.t_call(msgs, nbytes))
        if self.tracer is not None:
            self.tracer.emit(verb, msgs, nbytes,
                             collective=collective and self.n > 1,
                             window=window, fanout=self.n)

    def count_local(self, verb: str, msgs: int, nbytes: int = 0, *,
                    window: int = 0):
        """Count LOCAL-tier traffic: the same counter schema, kept out of
        the wire ledger (no ``modeled_s``, no tracer event)."""
        self._bump(self._local_stats, verb, msgs, nbytes, window)

    def stats(self) -> dict:
        """{verb: {calls, msgs, bytes, peak_outstanding, queue_hist
        [, modeled_s]}} accumulated since reset."""
        out = {}
        for src in (self._stats, self._local_stats):
            for k, v in src.items():
                d = dict(v)
                if "queue_hist" in d:
                    d["queue_hist"] = dict(d["queue_hist"])
                out[k] = d
        return out

    def reset_stats(self):
        self._stats = {}
        self._local_stats = {}
        self.plan_builds = 0

    def modeled_time(self, profile=None) -> float:
        """Modeled wall-clock of all counted traffic, under the bound
        profile or the one given."""
        p = netsim.get_profile(profile) if profile is not None \
            else self.profile
        if p is None:
            raise ValueError("no profile bound to this transport — pass "
                             "profile= here or at construction")
        return p.modeled_time(self._stats)

    # ------------------------------------------------------- recording ---

    def record_access(self, verb: str, region, idx, *,
                      region_len: Optional[int] = None, meta=None):
        """Record-only hook for an access that did not go through a verb
        (the RSI payload install).  No counting, no compute."""
        if self.recorder is not None and region is not None:
            self.recorder.record(verb, region, idx, region_len=region_len,
                                 meta=meta)

    def _rec_fence(self, kind: str):
        if self.recorder is not None:
            self.recorder.fence(kind)

    # ----------------------------------------------------------- verbs ---

    def _record(self, verb, region, idx, arr, **kw):
        if self.recorder is None or region is None:
            return None
        return self.recorder.record(verb, region, idx,
                                    region_len=arr.shape[0], **kw)

    def read(self, region_arr, idx, *, region=None):
        self._count("read", idx.numel(),
                    idx.numel() * _row_bytes(region_arr))
        out = _verbs.read(region_arr, idx)
        self._record("READ", region, idx, region_arr)
        return out

    def write(self, region_arr, idx, values, *, region=None):
        self._count("write", idx.numel(), _nbytes(values))
        out = _verbs.write(region_arr, idx, values)
        self._record("WRITE", region, idx, region_arr)
        return out

    def cas(self, words, idx, expected, new, priority=None, *, region=None):
        self._count("cas", idx.numel(), idx.numel() * (
            expected.element_size() + new.element_size()))
        ok, out = _verbs.cas(words, idx, expected, new, priority=priority,
                             impl=self.impl)
        self._record("CAS", region, idx, words, ok=ok, new=new)
        return ok, out

    def fetch_add(self, words, idx, delta, priority=None, *, region=None):
        self._count("fetch_add", idx.numel(),
                    idx.numel() * delta.element_size())
        out = _verbs.fetch_add(words, idx, delta, priority=priority)
        self._record("FETCH_ADD", region, idx, words)
        return out

    # ---------------------------------------------------- async verbs ----

    def _deferred(self, value, acc):
        rec = self.recorder
        on_wait = (lambda: rec.complete(acc)) if acc is not None else None
        return _verbs.Completion(value, on_wait=on_wait)

    def read_async(self, region_arr, idx, *, region=None):
        """Async READ: counts and computes like :meth:`read`; the access is
        recorded deferred and its fence fires at ``wait()``."""
        self._count("read", idx.numel(),
                    idx.numel() * _row_bytes(region_arr))
        out = _verbs.read(region_arr, idx)
        return self._deferred(out, self._record("READ", region, idx,
                                                region_arr, deferred=True))

    def write_async(self, region_arr, idx, values, *, region=None):
        """Async WRITE: ``wait()`` is a signaled write (a completion
        fence the plain WRITE never has)."""
        self._count("write", idx.numel(), _nbytes(values))
        out = _verbs.write(region_arr, idx, values)
        return self._deferred(out, self._record("WRITE", region, idx,
                                                region_arr, deferred=True))

    # ---------------------------------------------------------- router ---

    def _route_counted(self, fields, dest, *, cap, chunks, plan, mask,
                       window, overlap):
        n = self.n
        if plan is not None:
            cap = plan.cap
            if window is None:
                window = plan.window
        elif cap is None:
            raise ValueError("route needs cap= (or a plan=)")
        nbytes = n * cap * _router.WORD_BYTES * _router.packed_row_words(
            fields)
        self._count("route", n * chunks, nbytes,
                    window=int(window or 0), collective=True)
        exchange = (self._make_exchange(cap // chunks, 1) if overlap
                    else self._make_exchange(cap, chunks))
        return _router.route(fields, dest, n=n, cap=cap, chunks=chunks,
                             exchange=exchange, plan=plan, mask=mask,
                             window=window, overlap=overlap, impl=self.impl)

    def route(self, fields, dest=None, *, cap: Optional[int] = None,
              chunks: int = 1, plan=None, mask=None,
              window: Optional[int] = None, overlap: bool = False):
        """Radix-route a request pytree into (n, cap) buffers and exchange
        them: ``n * chunks`` messages whatever the field count, billed
        the packed buffer's bytes.  ``plan=``/``mask=``/``window=``/
        ``overlap=`` as in :func:`repro_torch.fabric.router.route`."""
        res = self._route_counted(fields, dest, cap=cap, chunks=chunks,
                                  plan=plan, mask=mask, window=window,
                                  overlap=overlap)
        self._rec_fence("route-roundtrip")
        return res

    def route_async(self, fields, dest=None, *, cap: Optional[int] = None,
                    chunks: int = 1, plan=None, mask=None,
                    window: Optional[int] = None, overlap: bool = True):
        """Async route: counts and computes like :meth:`route`, but the
        route-roundtrip fence moves to the Completion's ``wait()``."""
        res = self._route_counted(fields, dest, cap=cap, chunks=chunks,
                                  plan=plan, mask=mask, window=window,
                                  overlap=overlap)
        return _verbs.Completion(
            res, on_wait=lambda: self._rec_fence("route-roundtrip"))

    def plan_route(self, dest, *, cap: int, window: int = 0):
        """Precompute the slot assignment for ``dest`` (the rank kernel on
        the card); counted in ``plan_builds``, not in ``stats()``."""
        self.plan_builds += 1
        return _router.plan_route(dest, n=self.n, cap=cap, window=window,
                                  impl=self.impl)

    # ------------------------------------------------ substrate hooks ----

    @property
    def n(self) -> int:
        raise NotImplementedError

    def _make_exchange(self, cap: int, chunks: int):
        raise NotImplementedError

    def run(self, body, args, out_reps):
        raise NotImplementedError

    def shard_index(self):
        raise NotImplementedError

    def psum(self, x):
        raise NotImplementedError

    def all_gather(self, x):
        raise NotImplementedError

    def exchange(self, v, chunks: int = 1):
        raise NotImplementedError


class LocalTransport(Transport):
    """Single shard: the router partitions locally, collectives are
    identities; every counter still accumulates (loopback traffic)."""

    @property
    def n(self) -> int:
        return 1

    def _make_exchange(self, cap, chunks):
        return None

    def run(self, body, args, out_reps):
        return body(*args)

    def shard_index(self):
        return 0

    def psum(self, x):
        self._count("psum", 1, _nbytes(x), collective=True)
        self._rec_fence("psum")
        return x

    def all_gather(self, x):
        self._count("all_gather", 1, _nbytes(x), collective=True)
        self._rec_fence("all_gather")
        return x

    def exchange(self, v, chunks: int = 1):
        self._count("exchange", chunks, _nbytes(v), collective=True)
        self._rec_fence("exchange")
        return v
