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
trace time.  Under :class:`MeshTransport` a body runs once per shard, and
only shard 0 counts: JAX traces a ``shard_map`` body once, so it counts
each call site once, not once per shard.

``recorder=`` takes a :class:`~repro_torch.fabric.check.ScheduleRecorder`
(the race detector's) and ``tracer=`` an
:class:`~repro_torch.fabric.sim.EventTracer` (the contention simulator's);
with ``None`` they do nothing.

``device=`` is where the transport's tensors live: the card unless the
caller asks for the CPU (:func:`repro_torch._bits.resolve_device`).
``impl=`` is handed to the kernel dispatch (:mod:`repro_torch.kernels.ops`).
"""
from __future__ import annotations

import contextlib
import math
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from repro_torch._bits import resolve_device
from repro_torch.fabric import netsim
from repro_torch.fabric import router as _router
from repro_torch.fabric import verbs as _verbs
from repro_torch.spans import span


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

    def _quiet(self) -> bool:
        """Whether this call site is already counted: inside a
        :class:`MeshTransport` run, every shard but shard 0."""
        return False

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
        if self._quiet():
            return
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
        if not self._quiet():
            self._bump(self._local_stats, verb, msgs, nbytes, window)

    def stats(self) -> dict:
        """{verb: {calls, msgs, bytes, peak_outstanding, queue_hist
        [, modeled_s]}} accumulated since reset.  Tiered verbs count under
        suffixed keys: ``read_cold`` is wire traffic to a cold region,
        ``read_hot`` a hot-tier hit counted by :meth:`count_local` (no
        ``modeled_s``, never in :meth:`modeled_time`)."""
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
        if (self.recorder is not None and region is not None
                and not self._quiet()):
            self.recorder.record(verb, region, idx, region_len=region_len,
                                 meta=meta)

    def _rec_fence(self, kind: str):
        if self.recorder is not None and not self._quiet():
            self.recorder.fence(kind)

    # ----------------------------------------------------------- verbs ---

    def _record(self, verb, region, idx, arr, **kw):
        if self.recorder is None or region is None or self._quiet():
            return None
        return self.recorder.record(verb, region, idx,
                                    region_len=arr.shape[0], **kw)

    @staticmethod
    def _tiered(verb: str, tier) -> str:
        """Counter key of a verb call on a tier of a
        :class:`~repro_torch.fabric.verbs.TieredRegion`: ``read`` ->
        ``read_cold``.  The recorder still sees the plain READ or WRITE
        (races are tier-blind); the counters, the modeled time and the
        tracer carry the tier."""
        return f"{verb}_{tier}" if tier else verb

    def read(self, region_arr, idx, *, region=None, tier=None):
        self._count(self._tiered("read", tier), idx.numel(),
                    idx.numel() * _row_bytes(region_arr))
        out = _verbs.read(region_arr, idx)
        self._record("READ", region, idx, region_arr)
        return out

    def write(self, region_arr, idx, values, *, region=None, tier=None):
        self._count(self._tiered("write", tier), idx.numel(),
                    _nbytes(values))
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

    def read_async(self, region_arr, idx, *, region=None, tier=None):
        """Async READ: counts and computes like :meth:`read`; the access is
        recorded deferred and its fence fires at ``wait()``."""
        self._count(self._tiered("read", tier), idx.numel(),
                    idx.numel() * _row_bytes(region_arr))
        out = _verbs.read(region_arr, idx)
        return self._deferred(out, self._record("READ", region, idx,
                                                region_arr, deferred=True))

    def write_async(self, region_arr, idx, values, *, region=None,
                    tier=None):
        """Async WRITE: ``wait()`` is a signaled write (a completion
        fence the plain WRITE never has)."""
        self._count(self._tiered("write", tier), idx.numel(),
                    _nbytes(values))
        out = _verbs.write(region_arr, idx, values)
        return self._deferred(out, self._record("WRITE", region, idx,
                                                region_arr, deferred=True))

    # ---------------------------------------------------------- router ---

    def _route_counted(self, fields, dest, *, cap, chunks, plan, mask,
                       window, overlap):
        with span("fabric.route"):
            n = self.n
            if plan is not None:
                cap = plan.cap
                if window is None:
                    window = plan.window
            elif cap is None:
                raise ValueError("route needs cap= (or a plan=)")
            nbytes = n * cap * _router.WORD_BYTES * \
                _router.packed_row_words(fields)
            self._count("route", n * chunks, nbytes,
                        window=int(window or 0), collective=True)
            exchange = (self._make_exchange(cap // chunks, 1) if overlap
                        else self._make_exchange(cap, chunks))
            return _router.route(fields, dest, n=n, cap=cap, chunks=chunks,
                                 exchange=exchange, plan=plan, mask=mask,
                                 window=window, overlap=overlap,
                                 impl=self.impl)

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
        if not self._quiet():
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


# ------------------------------------------------------- n shards, one card --

class ShardFailure(RuntimeError):
    """A shard stopped at a collective: it waited past its time limit,
    the shards arrived at different collectives, or (``broken``) another
    shard failed first."""

    def __init__(self, msg: str, broken: bool = False):
        super().__init__(msg)
        self.broken = broken


class _Group:
    """The rendezvous of one :meth:`MeshTransport.run`.

    The shards take turns: one runs at a time, from one collective to its
    next, then hands the turn to the next shard; the last shard to reach
    a collective hands it back to shard 0, and every shard passes that
    collective in shard order.  So a collective is a barrier, the host
    issues the shards' work in a fixed order, and the threads never
    contend for the interpreter lock (each torch call drops it, and a
    contended hand-back costs a thread switch per call).  Values travel
    through two deposit slots used in turn: a shard one collective ahead
    never overwrites what another still reads."""

    def __init__(self, n: int, timeout: float):
        self.n = n
        self.timeout = timeout
        self.go = [threading.Event() for _ in range(n)]
        self.go[0].set()
        self.values = [[None] * n, [None] * n]
        self.tags = [[None] * n, [None] * n]
        self.error: Optional[BaseException] = None
        self.failed = False
        self._lock = threading.Lock()

    def fail(self, err: BaseException):
        """Record the first error a shard raised of its own (not a broken
        rendezvous, which only echoes another's) and wake every shard."""
        with self._lock:
            if self.error is None and not getattr(err, "broken", False):
                self.error = err
            self.failed = True
        for ev in self.go:
            ev.set()

    def wait_turn(self, shard: int, where: str):
        if not self.go[shard].wait(self.timeout):
            err = ShardFailure(f"shard {shard} at {where}: waited past "
                               f"{self.timeout} s for the other shards")
            self.fail(err)
            raise err
        self.go[shard].clear()
        if self.failed:
            raise ShardFailure(f"shard {shard} at {where}: another shard "
                               "failed", broken=True)

    def pass_turn(self, shard: int):
        self.go[(shard + 1) % self.n].set()

    def meet(self, shard: int, seq: int, kind: str, value) -> list:
        """Deposit ``value`` for collective ``seq`` of ``kind`` and wait
        for every shard's; returns the n values in shard order."""
        slot = seq % 2
        self.values[slot][shard] = value
        self.tags[slot][shard] = (kind, seq)
        self.pass_turn(shard)
        self.wait_turn(shard, f"{kind} #{seq}")
        tags = self.tags[slot]
        if any(t != tags[0] for t in tags):
            err = ShardFailure(f"the shards arrived at different "
                               f"collectives: {tags}")
            self.fail(err)
            raise err
        # every shard has read the previous collective's values by now
        self.values[1 - slot][shard] = None
        return list(self.values[slot])


class MeshTransport(Transport):
    """n shards on one device: the counterpart of the JAX package's
    ``MeshTransport`` over a mesh axis of n devices.

    :meth:`run` follows ``shard_map(in_specs=P(axis))``: every argument is
    split on axis 0 into n equal blocks (views, no copy) and the body runs
    once per shard, each in a host thread of its own (shard 0 in the
    caller's), with :meth:`shard_index` telling the shard.  The
    collectives (:meth:`psum`, :meth:`all_gather`, :meth:`exchange` and
    the router's exchange) are barriers: the shards take turns from one
    collective to the next (:class:`_Group`), and a collective combines
    the shards' values in shard order.  All shards issue to the caller's
    device and current stream, so the card runs their work in the order
    the host issued it, and a collective's inputs are issued before its
    outputs.

    A shard that raises stops the others at their next collective, and
    :meth:`run` raises the first shard's error; a shard that waits
    ``timeout`` seconds for its turn, or shards that arrive at different
    collectives, raise :class:`ShardFailure` in every shard.
    """

    def __init__(self, n: int, axis: str = "data", profile=None,
                 recorder=None, tracer=None, *, device=None, impl=None,
                 timeout: float = 60.0):
        super().__init__(profile=profile, recorder=recorder, tracer=tracer,
                         device=device, impl=impl)
        if int(n) < 1:
            raise ValueError(f"a mesh needs n >= 1 shards, got {n}")
        self._n = int(n)
        self.axis = axis
        self.timeout = float(timeout)
        self._tls = threading.local()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._one_run = threading.Lock()      # one run at a time

    @property
    def n(self) -> int:
        return self._n

    def _state(self):
        return getattr(self._tls, "state", None)

    def _quiet(self) -> bool:
        st = self._state()
        return st is not None and st[1] != 0

    # ------------------------------------------------------------ run ---

    def _blocks(self, k: int, a) -> list:
        if not isinstance(a, torch.Tensor) or a.dim() == 0:
            raise ValueError(f"argument {k} of run() is not a tensor with "
                             "an axis 0 to shard")
        L = a.shape[0]
        if L % self.n:
            raise ValueError(f"argument {k}: axis-0 length {L} does not "
                             f"split into {self.n} shards")
        b = L // self.n
        return [a[i * b:(i + 1) * b] for i in range(self.n)]

    def _shard(self, group: _Group, i: int, body, blocks, stream):
        self._tls.state = [group, i, 0]
        try:
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                group.wait_turn(i, "start")
                out = body(*blocks)
                self._meet("end", None)
            group.pass_turn(i)
            return out
        except BaseException as e:
            group.fail(e)
            raise
        finally:
            self._tls.state = None

    def run(self, body, args, out_reps):
        """Run ``body`` once per shard over axis-0 blocks of ``args``.
        out_reps: a bool (one output) or a tuple of bools; True takes
        shard 0's value (replicated), False concatenates the shards'
        values in shard order, or returns the argument whose blocks they
        are when the body returned its blocks (updated in place)."""
        if self._state() is not None:
            raise RuntimeError("MeshTransport.run inside a shard's body")
        with self._one_run:
            return self._run(body, args, out_reps)

    def _run(self, body, args, out_reps):
        n = self.n
        per_arg = [self._blocks(k, a) for k, a in enumerate(args)]
        shards = [[b[i] for b in per_arg] for i in range(n)]
        group = _Group(n, self.timeout)
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        if n > 1 and self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=n - 1,
                                            thread_name_prefix="shard")
        futs = [self._pool.submit(self._shard, group, i, body, shards[i],
                                  stream) for i in range(1, n)]
        outs, errors = [None] * n, []
        try:
            outs[0] = self._shard(group, 0, body, shards[0], None)
        except BaseException as e:
            errors.append(e)
        for i, f in enumerate(futs, 1):
            try:
                outs[i] = f.result()
            except BaseException as e:
                errors.append(e)
        if errors:
            raise group.error or errors[0]
        single = isinstance(out_reps, bool)
        reps = (out_reps,) if single else tuple(out_reps)
        vals = [(o,) if single else tuple(o) for o in outs]
        if any(len(v) != len(reps) for v in vals):
            raise ValueError(f"the body returned {len(vals[0])} outputs "
                             f"for {len(reps)} out_reps")
        merged = tuple(self._merge([v[j] for v in vals], rep, args, per_arg)
                       for j, rep in enumerate(reps))
        return merged[0] if single else merged

    @staticmethod
    def _merge(values, rep: bool, args, per_arg):
        if rep:
            return values[0]
        for a, blocks in zip(args, per_arg):
            if all(v is b for v, b in zip(values, blocks)):
                return a                     # the blocks, updated in place
        return torch.cat(values)

    # ------------------------------------------------------ collectives ---

    def _meet(self, kind: str, value) -> list:
        st = self._state()
        if st is None:
            raise RuntimeError(f"{kind} outside MeshTransport.run")
        group, shard, seq = st
        st[2] += 1
        return group.meet(shard, seq, kind, value)

    def gather(self, kind: str, x) -> list:
        """Every shard's ``x`` in shard order, once all have arrived at
        this collective (named ``kind``).  No counting."""
        return self._meet(kind, x)

    def shard_index(self) -> int:
        st = self._state()
        if st is None:
            raise RuntimeError("shard_index outside MeshTransport.run")
        return st[1]

    def _make_exchange(self, cap, chunks):
        n = self.n
        return lambda v: _router.chunked_all_to_all(v, self, n, cap, chunks)

    def psum(self, x):
        """Sum over the shards in shard order, in ``x``'s dtype: int32
        words wrap at 2**32, as the JAX package's u32 sums do."""
        self._count("psum", self.n, _nbytes(x), collective=True)
        self._rec_fence("psum")
        xs = self.gather("psum", x)
        out = xs[0]
        for y in xs[1:]:
            out = out + y
        return out

    def all_gather(self, x):
        """The shards' ``x`` concatenated on axis 0 (``tiled=True``)."""
        self._count("all_gather", self.n, self.n * _nbytes(x),
                    collective=True)
        self._rec_fence("all_gather")
        return torch.cat(self.gather("all_gather", x))

    def exchange(self, v, chunks: int = 1):
        """Paired reverse exchange of a (n*cap, ...) buffer: block i goes
        to shard i (the response path of routed requests)."""
        cap = v.shape[0] // self.n
        self._count("exchange", self.n * chunks, _nbytes(v),
                    collective=True)
        self._rec_fence("exchange")
        return _router.chunked_all_to_all(v, self, self.n, cap, chunks)


def make_transport(shards: int = 1, *, device=None, impl=None) -> Transport:
    """``LocalTransport`` for one shard, ``MeshTransport(shards)`` for more:
    what the bench modules run the same data on."""
    if shards == 1:
        return LocalTransport(device=device, impl=impl)
    return MeshTransport(shards, device=device, impl=impl)
