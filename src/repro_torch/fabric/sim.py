"""netsim v2: a discrete-event contention simulator for the verb fabric.

A copy of ``repro.fabric.sim`` kept in the port, so the port prices
traffic under load without importing the JAX package.  It is standard
library only (``heapq``, ``random``) apart from the port's own
:mod:`repro_torch.fabric.netsim`; the same trace gives a bit-identical
timeline in both packages.

``netsim`` prices a verb call in isolation (``t_call = setup +
msgs*max(cpu, 1/rate) + bytes/bw``).  This module prices a trace of calls
under load:

  * **shared full-duplex links**: every node has one egress (``tx``) and
    one ingress (``rx``) port of ``profile.bandwidth`` bytes/s each; a
    transfer src->dst occupies both, and concurrent transfers contend;
  * **NIC message-rate credit**: a serial per-node pipeline that admits
    one message per ``profile.per_message_s``; two-sided (SEND-style)
    verbs also burn receiver pipeline time, which is why WRITE out-rates
    SEND in the paper's Fig 4;
  * **per-agent bounded in-flight windows**: each agent keeps at most
    ``window`` verb calls outstanding; surplus calls queue FIFO;
  * **a pluggable link scheduler**: ``"fair"`` (fluid processor sharing
    of each port) or ``"fcfs"`` (a port serves one transfer at a time).

One verb call is a :class:`SimEvent`; a list of them is a **trace**,
synthesized directly, drawn by :func:`synthetic_load`, or recorded from a
real run by attaching an :class:`EventTracer` to a port transport
(``Transport(tracer=...)``) and replayed on any profile with
:func:`replay`.

Anchors to the analytic model: a lone call completes in exactly
``profile.t_call``; a single agent at ``window=1`` replays a trace in
exactly :func:`analytic_time`; every makespan is at least
:func:`analytic_lower_bound`; the engine consults no clock and no RNG.

:func:`contended_profile` derates a profile by the bandwidth a probe
transfer gets while ``load`` tenant streams share its ingress: what
``Planner(load=...)`` and ``Database.explain(load=...)`` price plans
with.
"""
from __future__ import annotations

import heapq
import random
from contextlib import contextmanager
from dataclasses import dataclass, replace
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.fabric import netsim

#: ``SimEvent.dst`` marker: a collective — the call fans out uniformly to
#: every node of the simulated fabric (the all_to_all / route motion).
ALL = -1

#: verbs whose completion involves the *receiver's* message pipeline
#: (two-sided semantics: posted receives, completion handling, the copy).
#: Everything else is one-sided — the remote CPU/NIC pipeline is bypassed,
#: which is the paper's §3.3 argument for WRITE over SEND.
TWO_SIDED = frozenset({"send", "recv", "send_recv"})

#: receiver pipeline cost of a two-sided message, in units of the
#: profile's per-message stage: posting the receive WQE, the completion
#: event, and the copy out of the bounce buffer.  Chosen so simulated
#: WRITE out-rates SEND by the Fig 4 margin (~2-4x at small messages).
SEND_RX_FACTOR = 4.0

_INF = float("inf")


# ------------------------------------------------------------- events ----


@dataclass(frozen=True)
class SimEvent:
    """One verb call in a trace.

    seq:    issue order (unique; agents issue their own events in seq
            order).
    verb:   fabric verb name ("read", "write", "route", ...) or the
            sim-only two-sided "send".
    msgs:   messages the call posts (the transport's counted ``msgs``).
    nbytes: wire bytes the call moves (the transport's counted ``bytes``).
    agent:  logical issuer — the unit the in-flight window throttles.
    src:    issuing node, or None = assign from the agent (stable
            round-robin over the fabric at sim time).
    dst:    target node; :data:`ALL` = collective fan-out to every node
            (each source ships ``nbytes``, split uniformly over its
            peers); None = a stable rotating remote.
    window: doorbell-batching cap — max in-flight flows per source *of
            this call* (0 = post everything at once).  This is the
            parameter ``route(window=...)`` records.
    at:     arrival time (seconds) — when the agent hands the call to the
            fabric; the agent window may queue it past this.
    fanout: participating sources recorded at trace time (a mesh route
            counts per-shard traffic); informational — expansion uses the
            simulator's ``nodes``.
    compute_s: pure local compute seconds — only meaningful with
            ``verb="compute"``: the event touches no wire and no NIC, it
            just occupies its agent's window for ``compute_s``.  This is
            how a recorded async schedule prices overlap: at window=1 the
            agent serializes compute behind its verbs (the synchronous
            analytic sum); at window>=2 a compute event runs while the
            preceding verb's flows are still on the wire.
    """
    seq: int
    verb: str
    msgs: float
    nbytes: float
    agent: str = "main"
    src: Optional[int] = None
    dst: Optional[int] = None
    window: int = 0
    at: float = 0.0
    fanout: int = 1
    compute_s: float = 0.0


class EventTracer:
    """Event-trace mode for a fabric transport (the sibling of
    ``check.ScheduleRecorder``): attach with ``Transport(tracer=...)`` and
    every counted verb call appends one :class:`SimEvent` — verb, msgs,
    bytes, issue order, window — so any existing run can be replayed
    through :func:`replay` on any network profile.  Observation only: it
    never changes computation or counters."""

    def __init__(self):
        self.events: List[SimEvent] = []
        self._agents: List[Tuple[str, Optional[int]]] = [("main", None)]

    @property
    def current_agent(self) -> str:
        return self._agents[-1][0]

    @contextmanager
    def agent(self, name: str, node: Optional[int] = None):
        """Attribute events inside the block to logical agent ``name``
        (optionally pinned to fabric node ``node``)."""
        self._agents.append((str(name), node))
        try:
            yield self
        finally:
            self._agents.pop()

    def emit(self, verb: str, msgs, nbytes, *, collective: bool = False,
             window: int = 0, fanout: int = 1) -> SimEvent:
        name, node = self._agents[-1]
        ev = SimEvent(seq=len(self.events), verb=str(verb),
                      msgs=float(msgs), nbytes=float(nbytes), agent=name,
                      src=node, dst=(ALL if collective else None),
                      window=int(window or 0), fanout=int(fanout))
        self.events.append(ev)
        return ev

    def emit_compute(self, compute_s: float) -> SimEvent:
        """Append a pure-compute event (no wire, no NIC — it occupies the
        agent's window for ``compute_s``).  Emit these between recorded
        verbs to mark the work an async schedule overlaps with the wire;
        replaying the trace at window=1 vs window>=2 then prices exactly
        what the overlap buys."""
        name, node = self._agents[-1]
        ev = SimEvent(seq=len(self.events), verb="compute", msgs=0.0,
                      nbytes=0.0, agent=name, src=node,
                      compute_s=float(compute_s))
        self.events.append(ev)
        return ev


# -------------------------------------------------------------- result ----


@dataclass
class SimResult:
    """Outcome of one simulated trace.

    makespan:     seconds from t=0 to the last completion.
    completions:  {event seq: completion time}.
    latency:      {event seq: completion - arrival} (queueing included).
    timeline:     [(time, kind, id)] in processing order — ``admit`` /
                  ``call-done`` carry the event seq, ``flow-wire`` /
                  ``flow-done`` the internal flow id.  Bit-identical
                  across runs of the same trace (the determinism
                  contract).
    peak_outstanding: {verb: max concurrent in-flight calls}.
    queue_depth_hist: {depth: times an agent's wait queue reached it}
                  (depth 0 = admitted without waiting).
    port_bytes:   {"tx3"/"rx0": bytes} — per-port wire volume.
    util:         {port: busy fraction of the makespan} (fluid).
    """
    makespan: float
    completions: Dict[int, float]
    latency: Dict[int, float]
    timeline: List[Tuple[float, str, int]]
    peak_outstanding: Dict[str, int]
    queue_depth_hist: Dict[int, int]
    port_bytes: Dict[str, float]
    util: Dict[str, float]

    def throughput(self, events: int) -> float:
        """Completed operations per second over the makespan."""
        return events / self.makespan if self.makespan > 0 else _INF


# ------------------------------------------------------------- engine ----


class _Flow:
    """One directed transfer of a call: src -> dst, its share of the
    call's msgs/bytes, walked through setup -> src NIC -> wire -> (rx NIC
    for two-sided) -> done."""

    __slots__ = ("fid", "call", "src", "dst", "msgs", "nbytes",
                 "remaining", "rate", "wire_key")

    def __init__(self, fid, call, src, dst, msgs, nbytes):
        self.fid = fid
        self.call = call
        self.src = src
        self.dst = dst
        self.msgs = msgs
        self.nbytes = nbytes
        self.remaining = float(nbytes)
        self.rate = 0.0
        self.wire_key: Tuple[float, int] = (_INF, fid)


class _Call:
    """One SimEvent in flight: its flows, per-source release FIFOs (the
    doorbell window), and the completion countdown."""

    __slots__ = ("ev", "flows", "pending", "released", "done",
                 "unfinished", "t_admit")

    def __init__(self, ev: SimEvent, flows: List[_Flow]):
        self.ev = ev
        self.flows = flows
        self.pending: Dict[int, List[_Flow]] = {}
        self.released: Dict[int, int] = {}
        self.done: Dict[int, int] = {}
        for f in flows:
            f.call = self
            self.pending.setdefault(f.src, []).append(f)
        self.unfinished = len(flows)
        self.t_admit = 0.0

    def inflight(self, src: int) -> int:
        return self.released.get(src, 0) - self.done.get(src, 0)


class FabricSim:
    """The discrete-event fabric: shared full-duplex links, NIC
    message-rate credit, bounded per-agent windows, pluggable link
    scheduler.  Construct once per experiment and :meth:`run` a trace.

    profile:   a :class:`~repro_torch.fabric.netsim.NetworkProfile` or preset
               name — the wire constants every resource is derated from.
    nodes:     fabric size (collective events fan out over these).
    window:    per-agent in-flight call cap (0 = unbounded); ``windows``
               overrides it per agent name.
    scheduler: "fair" (processor-sharing links) or "fcfs" (a port serves
               one transfer at a time, in arrival order).
    """

    SCHEDULERS = ("fair", "fcfs")

    def __init__(self, profile, *, nodes: int = 2, window: int = 0,
                 windows: Optional[Dict[str, int]] = None,
                 scheduler: str = "fair"):
        self.profile = netsim.get_profile(profile)
        self.nodes = max(int(nodes), 1)
        self.window = max(int(window), 0)
        self.windows = dict(windows or {})
        if scheduler not in self.SCHEDULERS:
            raise ValueError(f"scheduler {scheduler!r} not in "
                             f"{self.SCHEDULERS}")
        self.scheduler = scheduler

    # ------------------------------------------------------ expansion ----

    def _assign_nodes(self, trace: List[SimEvent]):
        """Stable node assignment: agents land on nodes in order of first
        appearance; auto point destinations rotate over the remotes."""
        agent_node: Dict[str, int] = {}
        for ev in trace:
            if ev.agent not in agent_node:
                agent_node[ev.agent] = len(agent_node) % self.nodes
        return agent_node

    def _expand(self, ev: SimEvent, src: int, fid0: int) -> List[_Flow]:
        """One SimEvent -> its directed flows.  A collective ships the
        event's (per-source) msgs/bytes from every node, split uniformly
        over that node's peers; a point event is one flow.  Loopback
        (src == dst, or a collective on a 1-node fabric) skips the wire
        but still pays the NIC pipeline.  A pure-compute event expands to
        no flows at all (it never touches a port or a NIC)."""
        if ev.verb == "compute":
            return []
        flows: List[_Flow] = []
        if ev.dst == ALL:
            peers = self.nodes - 1
            if peers == 0:
                flows.append(_Flow(fid0, None, 0, 0, ev.msgs, 0.0))
            else:
                fid = fid0
                for s in range(self.nodes):
                    for d in range(self.nodes):
                        if s == d:
                            continue
                        flows.append(_Flow(fid, None, s, d,
                                           ev.msgs / peers,
                                           ev.nbytes / peers))
                        fid += 1
        else:
            dst = ev.dst
            if dst is None:
                dst = ((src + 1 + ev.seq % max(self.nodes - 1, 1))
                       % self.nodes) if self.nodes > 1 else src
            nbytes = 0.0 if dst == src else ev.nbytes
            flows.append(_Flow(fid0, None, src, int(dst), ev.msgs, nbytes))
        return flows

    # ------------------------------------------------------------ run ----

    def run(self, trace: Iterable[SimEvent]) -> SimResult:
        trace = sorted(trace, key=lambda e: (e.at, e.seq))
        p = self.profile
        per_msg = p.per_message_s
        bw = p.bandwidth
        agent_node = self._assign_nodes(trace)

        heap: List[Tuple[float, int, str, object]] = []
        tick = 0

        def push(t, kind, obj):
            nonlocal tick
            tick += 1
            heapq.heappush(heap, (t, tick, kind, obj))

        now = 0.0
        timeline: List[Tuple[float, str, int]] = []
        completions: Dict[int, float] = {}
        latency: Dict[int, float] = {}
        nic_free = [0.0] * self.nodes
        wire: List[_Flow] = []
        dirty = [True]
        agent_q: Dict[str, List[_Call]] = {}
        agent_inflight: Dict[str, int] = {}
        verb_inflight: Dict[str, int] = {}
        peak_outstanding: Dict[str, int] = {}
        queue_hist: Dict[int, int] = {}
        port_bytes: Dict[str, float] = {}
        port_busy: Dict[str, float] = {}
        fid_counter = [0]

        def agent_window(agent: str) -> int:
            return int(self.windows.get(agent, self.window))

        def admit(call: _Call, t: float):
            ev = call.ev
            call.t_admit = t
            agent_inflight[ev.agent] = agent_inflight.get(ev.agent, 0) + 1
            verb_inflight[ev.verb] = verb_inflight.get(ev.verb, 0) + 1
            peak_outstanding[ev.verb] = max(
                peak_outstanding.get(ev.verb, 0), verb_inflight[ev.verb])
            timeline.append((t, "admit", ev.seq))
            if ev.verb == "compute":
                # no doorbell, no flows: the call holds its agent-window
                # slot for compute_s and completes
                push(t + ev.compute_s, "compute", call)
                return
            # one setup latency per call (the posted batch's doorbell),
            # then the doorbell window releases flows per source
            push(t + p.setup_s, "setup", call)

        def try_admit(agent: str, t: float):
            w = agent_window(agent)
            q = agent_q.get(agent, [])
            while q and (w == 0 or agent_inflight.get(agent, 0) < w):
                admit(q.pop(0), t)

        def release(call: _Call, src: int, t: float):
            """Release the next pending flow(s) of ``call`` from ``src``
            up to the call's doorbell window."""
            pend = call.pending.get(src)
            if not pend:
                return
            cap = call.ev.window
            while pend and (cap == 0 or call.inflight(src) < cap):
                f = pend.pop(0)
                call.released[src] = call.released.get(src, 0) + 1
                enter_nic(f, t)

        def enter_nic(f: _Flow, t: float):
            start = max(t, nic_free[f.src])
            done = start + f.msgs * per_msg
            nic_free[f.src] = done
            push(done, "nic", f)

        def enter_wire(f: _Flow, t: float):
            if f.nbytes <= 0.0 or f.src == f.dst:
                after_wire(f, t)
                return
            f.wire_key = (t, f.fid)
            f.remaining = float(f.nbytes)
            wire.append(f)
            timeline.append((t, "flow-wire", f.fid))
            port_bytes[f"tx{f.src}"] = port_bytes.get(f"tx{f.src}", 0.0) \
                + f.nbytes
            port_bytes[f"rx{f.dst}"] = port_bytes.get(f"rx{f.dst}", 0.0) \
                + f.nbytes
            dirty[0] = True

        def after_wire(f: _Flow, t: float):
            if f.call.ev.verb in TWO_SIDED and f.src != f.dst:
                start = max(t, nic_free[f.dst])
                done = start + f.msgs * per_msg * SEND_RX_FACTOR
                nic_free[f.dst] = done
                push(done, "rx", f)
            else:
                flow_done(f, t)

        def complete_call(call: _Call, t: float):
            ev = call.ev
            completions[ev.seq] = t
            latency[ev.seq] = t - ev.at
            timeline.append((t, "call-done", ev.seq))
            agent_inflight[ev.agent] -= 1
            verb_inflight[ev.verb] -= 1
            try_admit(ev.agent, t)

        def flow_done(f: _Flow, t: float):
            timeline.append((t, "flow-done", f.fid))
            call = f.call
            call.done[f.src] = call.done.get(f.src, 0) + 1
            release(call, f.src, t)
            call.unfinished -= 1
            if call.unfinished == 0:
                complete_call(call, t)

        # -------------------------------------------------- schedulers --

        def recompute():
            if not dirty[0]:
                return
            dirty[0] = False
            if self.scheduler == "fair":
                tx_n: Dict[int, int] = {}
                rx_n: Dict[int, int] = {}
                for f in wire:
                    tx_n[f.src] = tx_n.get(f.src, 0) + 1
                    rx_n[f.dst] = rx_n.get(f.dst, 0) + 1
                for f in wire:
                    f.rate = bw * min(1.0 / tx_n[f.src], 1.0 / rx_n[f.dst])
            else:                                          # fcfs
                tx_head: Dict[int, _Flow] = {}
                rx_head: Dict[int, _Flow] = {}
                for f in wire:
                    h = tx_head.get(f.src)
                    if h is None or f.wire_key < h.wire_key:
                        tx_head[f.src] = f
                    h = rx_head.get(f.dst)
                    if h is None or f.wire_key < h.wire_key:
                        rx_head[f.dst] = f
                for f in wire:
                    f.rate = bw if (tx_head[f.src] is f
                                    and rx_head[f.dst] is f) else 0.0

        def next_wire() -> Tuple[float, Optional[_Flow]]:
            recompute()
            best_t, best_f = _INF, None
            for f in wire:
                if f.rate > 0.0:
                    t = now + f.remaining / f.rate
                    if t < best_t or (t == best_t and best_f is not None
                                      and f.fid < best_f.fid):
                        best_t, best_f = t, f
            return best_t, best_f

        def advance(t: float):
            nonlocal now
            if t > now:
                dt = t - now
                for f in wire:
                    if f.rate > 0.0:
                        f.remaining = max(0.0, f.remaining - f.rate * dt)
                        key = f"tx{f.src}"
                        port_busy[key] = port_busy.get(key, 0.0) \
                            + f.rate / bw * dt
                        key = f"rx{f.dst}"
                        port_busy[key] = port_busy.get(key, 0.0) \
                            + f.rate / bw * dt
                now = t

        # ------------------------------------------------------ arrive --

        for ev in trace:
            push(ev.at, "arrive", ev)

        while heap or wire:
            t_wire, wf = next_wire()
            t_heap = heap[0][0] if heap else _INF
            if wf is not None and t_wire <= t_heap:
                advance(t_wire)
                wire.remove(wf)
                wf.remaining = 0.0
                dirty[0] = True
                after_wire(wf, now)
                continue
            t, _, kind, obj = heapq.heappop(heap)
            advance(t)
            if kind == "arrive":
                ev = obj
                src = ev.src if ev.src is not None \
                    else agent_node[ev.agent] % self.nodes
                call = _Call(ev, self._expand(ev, src, fid_counter[0]))
                fid_counter[0] += len(call.flows)
                w = agent_window(ev.agent)
                if w == 0 or agent_inflight.get(ev.agent, 0) < w:
                    queue_hist[0] = queue_hist.get(0, 0) + 1
                    admit(call, now)
                else:
                    q = agent_q.setdefault(ev.agent, [])
                    q.append(call)
                    depth = len(q)
                    queue_hist[depth] = queue_hist.get(depth, 0) + 1
            elif kind == "setup":
                call = obj
                for src in sorted(call.pending):
                    release(call, src, now)
            elif kind == "compute":
                complete_call(obj, now)
            elif kind == "nic":
                enter_wire(obj, now)
            elif kind == "rx":
                flow_done(obj, now)

        util = {k: (v / now if now > 0 else 0.0)
                for k, v in sorted(port_busy.items())}
        return SimResult(makespan=now, completions=completions,
                         latency=latency, timeline=timeline,
                         peak_outstanding=peak_outstanding,
                         queue_depth_hist=dict(sorted(queue_hist.items())),
                         port_bytes=dict(sorted(port_bytes.items())),
                         util=util)


# ------------------------------------------------------- trace algebra ----


def analytic_time(trace: Iterable[SimEvent], profile) -> float:
    """The isolated serial model of a trace: sum of
    ``profile.t_call(msgs, nbytes)`` over its events (a pure-compute
    event contributes its ``compute_s``) — exactly what a transport's
    ``modeled_s`` accumulates plus the declared compute.  The simulator
    reproduces this number for a single agent at ``window=1`` on point
    events (tested), and deviates from it exactly where contention or
    overlap matters — a window>=2 replay of a verbs+compute trace beating
    this sum IS the measured value of the async overlap."""
    p = netsim.get_profile(profile)
    return sum(e.compute_s if e.verb == "compute"
               else p.t_call(e.msgs, e.nbytes) for e in trace)


def analytic_lower_bound(trace: Iterable[SimEvent], profile, *,
                         nodes: int = 2) -> float:
    """A makespan floor no schedule can beat: the max of (a) any single
    port's byte work / bandwidth, (b) any single NIC's message work, and
    (c) the longest individual flow's intrinsic latency (arrival + setup
    + messages + wire).  ``FabricSim`` is work-conserving per resource, so
    every simulated makespan >= this bound (property-tested)."""
    p = netsim.get_profile(profile)
    sim = FabricSim(p, nodes=nodes)
    agent_node = sim._assign_nodes(list(trace))
    tx: Dict[int, float] = {}
    rx: Dict[int, float] = {}
    nic: Dict[int, float] = {}
    intrinsic = 0.0
    fid = 0
    for ev in trace:
        src = ev.src if ev.src is not None else agent_node[ev.agent] % nodes
        if ev.verb == "compute":
            intrinsic = max(intrinsic, ev.at + ev.compute_s)
            continue
        flows = sim._expand(ev, src, fid)
        fid += len(flows)
        for f in flows:
            nic[f.src] = nic.get(f.src, 0.0) + f.msgs * p.per_message_s
            wire_s = 0.0
            if f.nbytes > 0 and f.src != f.dst:
                tx[f.src] = tx.get(f.src, 0.0) + f.nbytes
                rx[f.dst] = rx.get(f.dst, 0.0) + f.nbytes
                wire_s = f.nbytes / p.bandwidth
            rx_s = (f.msgs * p.per_message_s * SEND_RX_FACTOR
                    if ev.verb in TWO_SIDED and f.src != f.dst else 0.0)
            intrinsic = max(intrinsic, ev.at + p.setup_s
                            + f.msgs * p.per_message_s + wire_s + rx_s)
    port = max([v / p.bandwidth for v in list(tx.values())
                + list(rx.values())] or [0.0])
    return max(port, max(nic.values() or [0.0]), intrinsic)


def replay(trace: Iterable[SimEvent], profile, *, nodes: int = 2,
           window: int = 0, windows: Optional[Dict[str, int]] = None,
           scheduler: str = "fair") -> SimResult:
    """Replay a recorded :class:`EventTracer` trace (or any event list)
    under contention on any profile — the netsim v2 workflow: record once,
    re-simulate anywhere on the 1GbE -> EDR axis, at any window."""
    return FabricSim(profile, nodes=nodes, window=window, windows=windows,
                     scheduler=scheduler).run(trace)


def synthetic_load(tenants: int, *, ops_per_tenant: int = 16,
                   op_bytes: float = 1 << 16, msgs_per_op: float = 1.0,
                   verb: str = "write", dst: Optional[int] = None,
                   spread_s: float = 0.0, seed: int = 0,
                   start_seq: int = 0) -> List[SimEvent]:
    """A seeded trace of concurrent tenant streams: tenant ``i`` issues
    ``ops_per_tenant`` point calls (agent ``tenant{i}``), arrivals
    jittered uniformly over ``spread_s`` seconds by ``random.Random(seed)``
    — the ONLY source of randomness in this module, so identical
    (arguments, seed) produce a bit-identical trace and therefore a
    bit-identical simulated timeline (the determinism contract)."""
    rng = random.Random(seed)
    events: List[SimEvent] = []
    seq = start_seq
    for i in range(int(tenants)):
        for _ in range(int(ops_per_tenant)):
            events.append(SimEvent(
                seq=seq, verb=verb, msgs=float(msgs_per_op),
                nbytes=float(op_bytes), agent=f"tenant{i}", dst=dst,
                at=rng.uniform(0.0, spread_s) if spread_s > 0 else 0.0))
            seq += 1
    return events


# ------------------------------------------------------- experiments -----


def window_sweep(profile, *, verb: str = "write", op_bytes: float = 4096,
                 n_ops: int = 256, windows: Iterable[int] = (1, 2, 4, 8,
                                                             16, 32, 64),
                 tenants: int = 1, scheduler: str = "fair",
                 msgs_per_op: float = 1.0) -> Dict[int, float]:
    """Throughput (ops/s, all tenants) vs the per-agent outstanding
    window — the related-repo microbench reproduced in the simulator:
    each of ``tenants`` clients (own source node) issues ``n_ops`` point
    calls of ``op_bytes`` at the shared server node, with at most
    ``window`` calls in flight.  Small windows are latency-bound
    (throughput ~ window / t_call); large windows saturate at the binding
    resource — the shared ingress link for byte-heavy ops, the NIC
    message pipeline for tiny ones, the receiver pipeline for two-sided
    ("send") verbs — so the curve bends instead of growing linearly."""
    p = netsim.get_profile(profile)
    out: Dict[int, float] = {}
    server = int(tenants)
    for w in windows:
        trace: List[SimEvent] = []
        seq = 0
        for tnt in range(tenants):
            for _ in range(n_ops):
                trace.append(SimEvent(
                    seq=seq, verb=verb, msgs=float(msgs_per_op),
                    nbytes=float(op_bytes), agent=f"client{tnt}",
                    src=tnt, dst=server))
                seq += 1
        res = FabricSim(p, nodes=tenants + 1, window=int(w),
                        scheduler=scheduler).run(trace)
        out[int(w)] = res.throughput(len(trace))
    return out


def percentile(values: Iterable[float], q: float) -> float:
    """Rank percentile (``q`` in [0, 1]): sort and take index
    ``min(N-1, int(q*N))``.  No interpolation — the returned number is an
    actually-observed latency, and the rank rule is deterministic, which
    keeps benchmark assertions bit-stable across runs."""
    vals = sorted(values)
    if not vals:
        raise ValueError("percentile of empty sequence")
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q={q} outside [0, 1]")
    return vals[min(len(vals) - 1, int(q * len(vals)))]


def completion_gaps(result: SimResult, seqs: Iterable[int]) -> List[float]:
    """Per-completion latency series of the chosen events: sort their
    simulated completion times and return consecutive gaps (the first gap
    is measured from t=0, so the opening ramp — e.g. the first wave's
    cold page-in — counts as a real latency sample).  For a serving trace
    whose per-round decode is one ``compute`` event, the gaps of those
    events ARE the per-token latencies ``fig_serve`` takes p50/p99 over."""
    ts = sorted(result.completions[int(s)] for s in seqs)
    return [b - a for a, b in zip([0.0] + ts[:-1], ts)]


def read_storm(profile, *, n_reads: int = 256, block_bytes: float = 4096,
               window: int = 0, clients: int = 1,
               scheduler: str = "fair") -> dict:
    """Price the paged-decode read storm: each of ``clients`` agents
    issues ``n_reads`` one-sided READs of ``block_bytes`` against the
    shared memory server, at most ``window`` in flight (0 = unbounded).
    This is the paper's Fig 4 small-message regime reopened for serving:
    at KV-block sizes the wire time per READ is tiny, so the binding
    resource is the NIC message pipeline, not bandwidth — checked here by
    construction, not assumption.

    Returns the simulated makespan next to its anchors:

      analytic_serial: the window=1 single-agent limit
        (:func:`analytic_time`) — the simulator lands exactly on it there
        (anchored in tests/test_sim.py);
      lower_bound:     :func:`analytic_lower_bound` for the same trace;
      nic_s / wire_s:  per-client NIC message work vs per-port byte work —
        whichever is larger is what saturation converges to;
      binding:         the analytic :meth:`NetworkProfile.bound` verdict
        for one READ ("msg_rate" on EDR at block sizes — the Fig 4 claim).
    """
    p = netsim.get_profile(profile)
    clients = max(int(clients), 1)
    server = clients
    trace: List[SimEvent] = []
    seq = 0
    for c in range(clients):
        for _ in range(int(n_reads)):
            trace.append(SimEvent(seq=seq, verb="read", msgs=1.0,
                                  nbytes=float(block_bytes),
                                  agent=f"client{c}", src=c, dst=server))
            seq += 1
    res = FabricSim(p, nodes=clients + 1, window=int(window),
                    scheduler=scheduler).run(trace)
    nic_s = int(n_reads) * p.per_message_s
    wire_s = int(n_reads) * clients * float(block_bytes) / p.bandwidth
    return {"profile": p.name, "n_reads": int(n_reads),
            "block_bytes": float(block_bytes), "clients": clients,
            "window": int(window), "makespan_s": res.makespan,
            "reads_per_s": res.throughput(len(trace)),
            "analytic_serial_s": analytic_time(trace, p),
            "lower_bound_s": analytic_lower_bound(trace, p,
                                                  nodes=clients + 1),
            "nic_s": nic_s, "wire_s": wire_s,
            "binding": p.bound(1.0, float(block_bytes)),
            "peak_outstanding": dict(res.peak_outstanding),
            "queue_depth_hist": dict(res.queue_depth_hist)}


def contended_profile(profile, load: int, *,
                      probe_bytes: float = 1 << 20) -> "netsim.NetworkProfile":
    """Derate a profile by measured contention: simulate ``load`` tenant
    streams (each from its own node) saturating one server's ingress
    while a probe transfer shares it, and fit the probe's effective
    bandwidth.  Under the fair-share scheduler this lands exactly at
    ``bandwidth / (1 + load)`` — but the number comes out of the
    simulator, not a formula, so a different scheduler or topology would
    flow straight through.  The per-message stage is unchanged (tenants
    own their source NICs; the shared resource is the wire).

    ``load=0`` returns the profile itself — plan choice at zero load is
    the isolated argmin by construction.  This is what ``Planner(load=)``
    and ``db.explain(load=)`` price plans with."""
    p = netsim.get_profile(profile)
    load = int(load)
    if load <= 0:
        return p
    nodes = load + 2
    trace: List[SimEvent] = []
    # tenants: one long-running stream each, sized to outlast the probe
    stream_bytes = float(probe_bytes) * (load + 2)
    for i in range(load):
        trace.append(SimEvent(seq=i, verb="write", msgs=1.0,
                              nbytes=stream_bytes, agent=f"tenant{i}",
                              src=i + 2, dst=0))
    probe = SimEvent(seq=load, verb="read", msgs=1.0,
                     nbytes=float(probe_bytes), agent="probe", src=1,
                     dst=0)
    trace.append(probe)
    res = FabricSim(p, nodes=nodes).run(trace)
    wire_s = (res.completions[probe.seq] - probe.at - p.setup_s
              - p.per_message_s)
    bw_eff = float(probe_bytes) / wire_s
    return replace(p, bandwidth=bw_eff,
                   name=f"{p.name}+load{load}")
