"""The Database: the NAM-DB facade over the port's verb fabric.

The port of ``repro.db.database``.  A :class:`Database` owns

  * a :class:`~repro_torch.fabric.NamPool` of named regions (tables
    allocate their stores there),
  * ONE transport (``LocalTransport`` on the card by default) through
    which every verb runs and is counted,
  * a timestamp oracle: a counter word bumped with the FETCH_ADD verb,
  * the network-aware :class:`~repro_torch.db.planner.Planner` that picks
    shuffle and aggregation strategies from the §5.1/§5.3 cost models.

OLTP: ``db.session()`` transactions commit through RSI (or the 2PC
baseline) in waves: ``db.commit([s1, s2, ...])`` is one routed
prepare/install round trip for the whole wave, with bounded,
deterministic retry of the losers.  OLAP:
``db.scan("R").join(db.scan("S").filter(sel=s)).aggregate()`` builds a
logical plan; ``db.execute(plan)`` runs the planner's argmin choice (or a
forced variant) and ``db.explain(plan)`` returns every costed alternative.

Two differences from the JAX facade: PyTorch runs eagerly, so every
``execute`` counts its traffic into ``stats`` (a jitted JAX shape counts
only on its first, traced, execution); and ``elapsed_s`` is taken after
``torch.cuda.synchronize()`` (JAX's ``block_until_ready``).

Over a :class:`~repro_torch.fabric.MeshTransport` of n shards the store
is range-sharded by home shard and a wave's clients split into n equal
blocks, so a table's records and timestamps, and every wave's writer
sessions, must divide by n (checked before anything is claimed).  Retry
waves come in power-of-two sizes (:func:`_dyadic`), so at n > 1 a retry
wave of fewer sessions than shards raises, as it cannot run in the JAX
package either: n-shard waves commit with ``max_retries=0``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch import fabric
from repro_torch._bits import CID_MASK, M32, np_to_i32, np_u32
from repro_torch.core import aggregation, rsi, shuffle, twopc
from repro_torch.db.plan import Plan
from repro_torch.db.planner import Planner
from repro_torch.db.session import Session
from repro_torch.db.table import Table, TableSchema
from repro_torch.spans import span

# modeled cluster size when running the single-shard degenerate case: the
# paper's §5.4 deployment, so planner choices match the target NAM cluster
DEFAULT_MODEL_NODES = 4

_BACKENDS = {"rsi": rsi.commit, "2pc": twopc.commit}

# one backoff slot of modeled compute between a hot-row abort and its
# retry round, priced through an attached sim tracer
BACKOFF_SLOT_S = 1e-6


def _dyadic(items: list) -> list:
    """Split a list into greedy power-of-two-sized chunks (23 -> 16+4+2+1)."""
    out, i = [], 0
    while i < len(items):
        size = 1 << ((len(items) - i).bit_length() - 1)
        out.append(items[i:i + size])
        i += size
    return out


def backoff_slots(txn_id: int, attempt: int) -> int:
    """Bounded-exponential retry backoff, jittered by a Fibonacci hash of
    the transaction id: deterministic, yet decorrelated across the txns
    that collided on the same hot row."""
    h = (int(txn_id) * 0x9E3779B1 + int(attempt) * 0x85EBCA77) & 0xFFFFFFFF
    return h % (1 << min(int(attempt), 16))


@dataclass(frozen=True)
class QueryResult:
    value: object                       # operator output (a tensor)
    variant: str                        # strategy that actually ran
    alternatives: tuple                 # costed Alternatives, argmin first
    plan: Plan
    elapsed_s: float
    stats: dict = field(default_factory=dict)   # fabric counter delta of
                                                # one execution
    dropped: Optional[int] = None       # join rows lost to capacity
                                        # overflow (None for aggregates)

    @property
    def planned(self) -> str:
        return next(a.name for a in self.alternatives if a.chosen)


@dataclass(frozen=True)
class Explain:
    plan: str                           # plan.describe()
    kind: str                           # join_agg | group_agg
    alternatives: tuple                 # argmin first
    inputs: dict                        # cost-model inputs (bytes, sel, ...)

    @property
    def chosen(self) -> str:
        return next(a.name for a in self.alternatives if a.chosen)

    def pretty(self) -> str:
        lines = [f"plan: {self.plan}",
                 f"inputs: {self.inputs}"]
        lines += [a.pretty() for a in self.alternatives]
        return "\n".join(lines)


class Database:
    """Tables + sessions + planner over one fabric transport."""

    def __init__(self, transport=None, *, device=None, impl=None,
                 net="rdma", model_nodes: Optional[int] = None):
        """transport: default ``LocalTransport(device=device, impl=impl)``.
        device: the card unless the caller asks for the CPU; with no card
        and no ``device=``, construction raises.  impl: the kernel
        dispatch (``None`` = the hand-written kernels on the card).
        net: what the planner models the wire as — a
        :class:`~repro_torch.fabric.NetworkProfile`, a preset name
        ("ethernet_1g" ... "rdma_edr") or a legacy key.  model_nodes: the
        cluster size the planner assumes (default: the transport's shard
        count, or the paper's 4 nodes for one shard)."""
        self.transport = transport or fabric.LocalTransport(device=device,
                                                            impl=impl)
        self.device = self.transport.device
        self.pool = fabric.NamPool()
        nodes = (model_nodes if model_nodes is not None else
                 (self.transport.n if self.transport.n > 1
                  else DEFAULT_MODEL_NODES))
        self.planner = Planner(net=net, nodes=nodes)
        self.tables: dict = {}
        # timestamp oracle: cid 1 is the load epoch, live txns start at 2
        self.pool.alloc("oracle/clock", (1,), torch.int32, ("replicated",))
        self._clock = torch.full((1,), 2, dtype=torch.int32,
                                 device=self.device)
        # per-txn outcome economics (the contention side of the ledger)
        self.txn_stats = {"commits": 0, "aborts": 0, "retries": 0,
                          "backoff_slots": 0}

    # ------------------------------------------------------------ tables --

    def create_table(self, name: str, num_records: int, *,
                     payload_words: int = 4, version_slots: int = 1,
                     partitioning: str = "range",
                     num_timestamps: int = 60_000) -> Table:
        n = self.transport.n
        for what, size in (("records", num_records),
                           ("timestamps", num_timestamps)):
            if size % n:
                raise ValueError(f"table {name!r}: {size} {what} do not "
                                 f"split over the {n} shards")
        schema = TableSchema(name=name, num_records=num_records,
                             payload_words=payload_words,
                             version_slots=version_slots,
                             partitioning=partitioning)
        t = Table(schema, self.pool, self.transport,
                  num_timestamps=num_timestamps)
        self.tables[name] = t
        return t

    def load_table(self, name: str, keys, vals, *,
                   partitioning: str = "hash") -> Table:
        """Create + bulk-load an OLAP relation in one call (payload word 0
        holds the value column; hash partitioning = shuffle by key).
        Columns as :meth:`Table.load` takes them."""
        t = self.create_table(name, num_records=len(keys), payload_words=1,
                              partitioning=partitioning)
        return t.load(keys, vals)

    def table(self, name_or_table) -> Table:
        if isinstance(name_or_table, Table):
            return name_or_table
        return self.tables[name_or_table]

    # ---------------------------------------------------- timestamp oracle --

    def claim_cids(self, k: int) -> np.ndarray:
        """Claim k commit timestamps with one FETCH_ADD on the oracle word.
        Returns them as numpy u32."""
        fetched, self._clock = self.transport.fetch_add(
            self._clock, torch.zeros((k,), dtype=torch.int32,
                                     device=self.device),
            torch.ones((k,), dtype=torch.int32, device=self.device),
            region="oracle/clock")
        return np_u32(fetched)

    def read_timestamp(self) -> int:
        """Current read snapshot: every cid below the clock is decided."""
        return (int(self._clock[0]) & M32) - 1

    # ---------------------------------------------------------- sessions --

    def session(self, isolation: str = "rsi") -> Session:
        return Session(self, isolation=isolation)

    def snapshot_read(self, table, recs, rid: Optional[int] = None):
        """Vectorized snapshot read outside any session: the newest version
        with CID <= rid (default: the oracle's read timestamp), as counted
        READs.  Returns (payload, read_cids, ok)."""
        t = self.table(table)
        rid = self.read_timestamp() if rid is None else int(rid)
        recs = torch.as_tensor(np.asarray(recs, np.int32), device=t.device)
        return rsi.read_snapshot(t.store, recs, rid,
                                 transport=self.transport,
                                 region_ns=f"{t.schema.name}/")

    def _priority(self, priority):
        if priority is None:
            return None
        return torch.as_tensor(np.asarray(priority, np.int32),
                               device=self.device)

    def commit(self, sessions: List[Session], *, chunks: int = 1,
               priority=None, max_retries: int = 0) -> np.ndarray:
        """Commit a wave of concurrent sessions as ONE batched fabric
        commit (one plan, one routed prepare and one routed install).
        Returns the per-session committed mask.

        max_retries: re-run aborted writers up to this many extra rounds,
        each after :func:`backoff_slots`, with the write set's current
        words re-read (one counted READ) and a fresh cid.  Outcomes land
        in ``txn_stats`` and the ``"txn"`` entry of :meth:`fabric_stats`."""
        if not sessions:
            return np.zeros((0,), bool)
        self._commit_wave(sessions, chunks=chunks, priority=priority)
        self._retry_losers(sessions, chunks=chunks, max_retries=max_retries)
        return np.asarray([bool(s.committed) for s in sessions], bool)

    def _commit_wave(self, sessions: List[Session], *, chunks: int = 1,
                     priority=None) -> np.ndarray:
        """One commit round for one wave — no retries, no accounting."""
        if not sessions:
            return np.zeros((0,), bool)
        isolation = sessions[0].isolation
        if any(s.isolation != isolation for s in sessions):
            raise ValueError("mixed isolation levels in one commit wave")
        # read-only sessions commit trivially under SI
        wave = sessions
        for s in wave:
            if s.table_name is None:
                s.committed = True
        sessions = [s for s in wave if s.table_name is not None]
        if not sessions:
            return np.ones((len(wave),), bool)
        names = {s.table_name for s in sessions}
        if len(names) != 1:
            raise ValueError(f"one table per commit wave, got {names}")
        t = self.table(names.pop())
        self._check_wave(len(sessions))
        txns, cids = self._pack_txns(t, sessions)
        ok, t.store = _BACKENDS[isolation](
            t.store, txns, transport=self.transport,
            priority=self._priority(priority), chunks=chunks,
            region_ns=f"{t.schema.name}/")
        self._complete_bitvec(t, cids)
        self._assign_outcomes(sessions, ok.cpu().numpy(), cids)
        return np.asarray([s.committed for s in wave], bool)

    def _check_wave(self, T: int):
        """A wave's writers split into one equal block of clients a shard
        (``shard_map``'s rule)."""
        n = self.transport.n
        if T % n:
            raise ValueError(f"a wave of {T} writer sessions does not split "
                             f"over the {n} shards")

    def _complete_bitvec(self, t: Table, cids):
        """msg 3 completion over n > 1 shards: the commit body flips only
        the bitvector bits inside each client shard's own range, but the
        oracle hands out globally contiguous cids, so the rest are
        finished here with one counted WRITE of the wave's cids (committed
        and aborted txns both burn their slot)."""
        if self.transport.n == 1:
            return
        idx = torch.from_numpy(np_to_i32(cids)).to(t.device)
        t.store["bitvec"] = self.transport.write(
            t.store["bitvec"], idx,
            torch.ones(idx.shape, dtype=torch.bool, device=t.device),
            region=f"{t.schema.name}/bitvec")

    def _assign_outcomes(self, sessions, ok, cids):
        for s, committed, cid in zip(sessions, np.asarray(ok), cids):
            s.committed = bool(committed)
            s.cid = int(cid)
            s.attempts += 1
            if s.txn_id is None:
                # stable retry identity: the txn's FIRST claimed cid
                s.txn_id = int(cid)

    # ------------------------------------------------- retry economics --

    def _retry_losers(self, sessions: List[Session], *, chunks: int,
                      max_retries: int):
        """Bounded retry of a wave's aborted writers + outcome accounting
        for the whole wave (commits include read-only txns)."""
        losers = [s for s in sessions
                  if s.table_name is not None and not s.committed]
        self.txn_stats["aborts"] += len(losers)
        attempt = 1
        while losers and attempt <= max_retries:
            self._backoff(losers, attempt)
            self._refresh_losers(losers)
            self.txn_stats["retries"] += len(losers)
            # retry waves run in power-of-two sizes, as in the JAX
            # facade, so the two give the same wave shapes and counters
            for chunk in _dyadic(losers):
                self._commit_wave(chunk, chunks=chunks)
            losers = [s for s in losers if not s.committed]
            self.txn_stats["aborts"] += len(losers)
            attempt += 1
        self.txn_stats["commits"] += sum(bool(s.committed) for s in sessions)

    def _refresh_losers(self, losers: List[Session]):
        """ONE counted READ re-fetches the current word of every loser's
        write set; each session revalidates against its slice."""
        t = self.table(losers[0].table_name)
        per = [np.concatenate(s._recs) for s in losers]
        words = self.transport.read(
            t.store["words"],
            torch.as_tensor(np.concatenate(per), device=t.device),
            region=f"{t.schema.name}/words")
        fresh = np_u32(words) & np.uint32(CID_MASK)
        rid = self.read_timestamp()
        off = 0
        for s, recs in zip(losers, per):
            k = recs.shape[0]
            s._recs = [recs]
            s._payload = [np.concatenate(s._payload)]
            s._read_cids = [fresh[off:off + k]]
            s.rid = rid
            off += k

    def _backoff(self, losers: List[Session], attempt: int):
        slots = sum(backoff_slots(s.txn_id or 0, attempt) for s in losers)
        self.txn_stats["backoff_slots"] += slots
        tracer = getattr(self.transport, "tracer", None)
        if tracer is not None and slots:
            # losers back off concurrently: the wave waits the LONGEST
            worst = max(backoff_slots(s.txn_id or 0, attempt)
                        for s in losers)
            tracer.emit_compute(worst * BACKOFF_SLOT_S)

    def commit_grouped(self, groups: List[List[Session]], *,
                       chunks: Optional[int] = None, priority=None,
                       max_retries: int = 0) -> List[np.ndarray]:
        """Commit K per-worker session groups as ONE coalesced RSI wave
        (:func:`repro_torch.core.rsi.commit_grouped`).  Timestamps are
        claimed group by group.  Returns the per-group committed masks;
        losers across all groups retry together as plain waves."""
        groups = [list(g) for g in groups]
        flat = [s for g in groups for s in g]
        if not flat:
            return [np.zeros((0,), bool) for _ in groups]
        if any(s.isolation != "rsi" for s in flat):
            raise ValueError("commit_grouped is RSI-only")
        for s in flat:
            if s.table_name is None:
                s.committed = True
        writer_groups = [[s for s in g if s.table_name is not None]
                         for g in groups]
        writer_groups = [g for g in writer_groups if g]
        if writer_groups:
            names = {s.table_name for g in writer_groups for s in g}
            if len(names) != 1:
                raise ValueError(f"one table per grouped commit, "
                                 f"got {names}")
            t = self.table(names.pop())
            self._check_wave(sum(len(g) for g in writer_groups))
            packed = [self._pack_txns(t, g) for g in writer_groups]
            cids = np.concatenate([c for _, c in packed])
            oks, t.store = rsi.commit_grouped(
                t.store, [txns for txns, _ in packed],
                transport=self.transport,
                priority=None if priority is None else
                [self._priority(p) for p in priority],
                chunks=chunks, region_ns=f"{t.schema.name}/")
            self._complete_bitvec(t, cids)
            ok = np.concatenate([o.cpu().numpy() for o in oks])
            self._assign_outcomes(
                [s for g in writer_groups for s in g], ok, cids)
        self._retry_losers(flat, chunks=1, max_retries=max_retries)
        return [np.asarray([bool(s.committed) for s in g], bool)
                for g in groups]

    def _pack_txns(self, t: Table, sessions: List[Session]):
        """Batch one wave of writer sessions into a TxnBatch (T fixed W
        write slots, record -1 = unused) and claim its commit timestamps."""
        writes = [s.writes() for s in sessions]
        T = len(sessions)
        W = max(r.shape[0] for r, _, _ in writes)
        m = t.schema.payload_words
        recs = np.full((T, W), -1, np.int32)
        pay = np.zeros((T, W, m), np.uint32)
        rcids = np.zeros((T, W), np.uint32)
        for i, (r, p, rc) in enumerate(writes):
            if r.shape[0]:
                recs[i, :r.shape[0]] = r
                pay[i, :r.shape[0]] = p
                rcids[i, :r.shape[0]] = rc
        cids = self.claim_cids(T)
        txns = rsi.TxnBatch.from_numpy(recs, rcids, pay, cids,
                                       device=self.device)
        return txns, cids

    def commit_pipelined(self, waves: List[List[Session]], *,
                         chunks: int = 1,
                         max_retries: int = 0) -> List[np.ndarray]:
        """Commit K *dependent* session waves with wave i's install round
        trip overlapping wave i+1's prepare
        (:func:`repro_torch.core.rsi.commit_pipelined` — RSI only); the
        same outcome as K sequential :meth:`commit` calls.  Returns the
        per-wave committed masks."""
        waves = [list(w) for w in waves]
        writer_waves = []
        table = None
        for w in waves:
            if any(s.isolation != "rsi" for s in w):
                raise ValueError("commit_pipelined is RSI-only")
            for s in w:
                if s.table_name is None:
                    s.committed = True
            writers = [s for s in w if s.table_name is not None]
            if not writers:
                continue
            names = {s.table_name for s in writers}
            if len(names) != 1:
                raise ValueError(f"one table per commit wave, got {names}")
            t = self.table(names.pop())
            if table is None:
                table = t
            elif t is not table:
                raise ValueError("one table per pipelined commit")
            self._check_wave(len(writers))
            writer_waves.append(writers)
        # (sessions, cids) and the batch of each writer wave, in order
        writer_meta, txns_list = [], []
        for writers in writer_waves:
            txns, cids = self._pack_txns(table, writers)
            txns_list.append(txns)
            writer_meta.append((writers, cids))
        if txns_list:
            oks, table.store = rsi.commit_pipelined(
                table.store, txns_list, transport=self.transport,
                chunks=chunks, region_ns=f"{table.schema.name}/")
            for (sessions, cids), ok in zip(writer_meta, oks):
                self._complete_bitvec(table, cids)
                self._assign_outcomes(sessions, ok.cpu().numpy(), cids)
        self._retry_losers([s for w in waves for s in w], chunks=chunks,
                           max_retries=max_retries)
        return [np.asarray([s.committed for s in w], bool) for w in waves]

    # ------------------------------------------------------------ queries --

    def scan(self, table) -> Plan:
        name = table.schema.name if isinstance(table, Table) else table
        if name not in self.tables:
            raise KeyError(f"no table {name!r}")
        return Plan("scan", table=name)

    def _planner_for(self, profile, load: int = 0) -> Planner:
        """The db's planner, or a per-(profile, load) one (same modeled
        cluster) for sweeping the 1GbE -> EDR axis and the tenant-load
        axis without touching db state."""
        load = max(int(load), 0)
        if profile is None and load == self.planner.load:
            return self.planner
        base = profile if profile is not None else self.planner.profile
        return Planner(net=base, nodes=self.planner.nodes, load=load)

    def _analyze(self, plan: Plan, planner: Optional[Planner] = None):
        """(kind, alternatives argmin-first, cost-model inputs)."""
        planner = planner or self.planner
        kind = plan.kind()
        if kind == "join_agg":
            join = plan.children[0]
            left, right = join.children
            rtab = self.table(left.scan_table())
            stab = self.table(right.scan_table())
            sel = left.selectivity() * right.selectivity()
            nr, ns = rtab.stats()["bytes"], stab.stats()["bytes"]
            alts = planner.join_alternatives(nr, ns, sel)
            return kind, alts, {"nr_bytes": nr, "ns_bytes": ns, "sel": sel,
                                "net": planner.net, "load": planner.load,
                                "profile": planner.profile.name}
        if kind == "group_agg":
            if plan.groups is None:
                raise ValueError("a group aggregate needs "
                                 ".aggregate(groups=G); bare .aggregate() "
                                 "is the scalar join aggregate")
            child = plan.children[0]
            tab = self.table(child.scan_table())
            nb = tab.stats()["bytes"]
            alts = planner.agg_alternatives(nb, plan.groups)
            return kind, alts, {"nbytes": nb, "groups": plan.groups,
                                "nodes": planner.nodes,
                                "net": planner.net, "load": planner.load,
                                "profile": planner.profile.name}
        raise ValueError(f"cannot plan a bare {kind} — add .aggregate()")

    def explain(self, plan: Plan, *, profile=None, load: int = 0) -> Explain:
        """Costed alternatives for a plan, argmin first — no execution.
        ``profile`` prices the plan on another point of the network axis
        (preset name or NetworkProfile) without changing db state;
        ``load`` prices it under that many concurrent tenant streams
        (``sim.contended_profile``): the argmin under contention can
        differ from the isolated one (fig10)."""
        kind, alts, inputs = self._analyze(plan,
                                           self._planner_for(profile, load))
        return Explain(plan.describe(), kind, tuple(alts), inputs)

    def execute(self, plan: Plan, *, force_variant: Optional[str] = None,
                capacity_factor: float = 2.0,
                calibrate: bool = False, profile=None,
                load: int = 0) -> QueryResult:
        """Run a plan with the planner's choice (or ``force_variant``).
        Returns the value, the full costed explain, this execution's
        counter delta (``stats``) and, for a join, the rows lost to
        capacity overflow (``dropped``).

        calibrate=True runs the operator once more and feeds the planner
        the first run's byte counters plus the second run's wall clock
        (kernel builds excluded) minus the variant's modeled compute share,
        so later plans are priced with the measured wire rate; the result
        carries the second run's time."""
        with span("db.execute"):
            with span("db.plan"):
                kind, alts, inputs = self._analyze(
                    plan, self._planner_for(profile, load))
                variant = force_variant or Planner.chosen(alts)
                if force_variant:
                    known = {a.name for a in alts}
                    if force_variant not in known:
                        raise ValueError(f"{force_variant!r} not in "
                                         f"{sorted(known)}")
            if kind == "join_agg":
                join = plan.children[0]
                rtab = self.table(join.children[0].scan_table())
                stab = self.table(join.children[1].scan_table())
                f = shuffle.make_distributed_join(
                    self.transport, variant, capacity_factor=capacity_factor,
                    return_stats=True)
                args = rtab.scan_arrays() + stab.scan_arrays()
            else:
                tab = self.table(plan.children[0].scan_table())
                mk = (aggregation.dist_agg if variant == "dist_agg"
                      else aggregation.rdma_agg)
                f = mk(self.transport, plan.groups)
                args = tab.scan_arrays()
            before = self._stats_totals()
            out, elapsed = self._timed(f, args)
            stats = self._stats_delta(before)
            if calibrate:
                out, elapsed = self._timed(f, args)
                if stats:
                    self.planner.calibrate(
                        stats, elapsed,
                        compute_s=self.planner.compute_share(kind, variant,
                                                             inputs))
            value, dropped = out if kind == "join_agg" else (out, None)
            return QueryResult(
                value=value, variant=variant, alternatives=tuple(alts),
                plan=plan, elapsed_s=elapsed, stats=stats,
                dropped=None if dropped is None else int(dropped))

    def _timed(self, f, args):
        """(f(*args), seconds until the device has finished it)."""
        t0 = time.perf_counter()
        with span("db.run"):
            out = f(*args)
        if self.device.type == "cuda":
            with span("db.sync"):
                torch.cuda.synchronize(self.device)
        return out, time.perf_counter() - t0

    # ------------------------------------------------------- observability --

    def _stats_totals(self) -> dict:
        return {k: dict(v) for k, v in self.transport.stats().items()}

    def _stats_delta(self, before: dict) -> dict:
        out = {}
        for verb, s in self.transport.stats().items():
            b = before.get(verb, {})
            d = {}
            for k, v in s.items():
                if isinstance(v, dict):
                    # queue_hist: histogram delta per bucket
                    bv = b.get(k, {})
                    hd = {kk: vv - bv.get(kk, 0) for kk, vv in v.items()
                          if vv - bv.get(kk, 0)}
                    if hd:
                        d[k] = hd
                elif k == "peak_outstanding":
                    # a high-water mark, not a counter: report the
                    # current peak, it cannot be differenced
                    d[k] = v
                else:
                    d[k] = v - b.get(k, 0)
            numeric = {k: v for k, v in d.items()
                       if k not in ("peak_outstanding",)
                       and not isinstance(v, dict)}
            if any(numeric.values()):
                out[verb] = d
        return out

    def fabric_stats(self) -> dict:
        """Cumulative per-verb message/byte counters, plus a ``"txn"``
        pseudo-verb with the commit/abort/retry economics once any
        transaction has committed through this database, and a ``"tiers"``
        pseudo-verb with the hot-tier hit rate of each verb once any verb
        ran tiered (``read_hot``/``read_cold``, ``write_hot``/
        ``write_cold``)."""
        stats = dict(self.transport.stats())
        if any(self.txn_stats.values()):
            stats["txn"] = {"calls": self.txn_stats["commits"]
                            + self.txn_stats["aborts"],
                            "msgs": 0, "bytes": 0, **self.txn_stats}
        rates = {}
        for verb in ("read", "write"):
            hot = stats.get(f"{verb}_hot", {}).get("msgs", 0)
            cold = stats.get(f"{verb}_cold", {}).get("msgs", 0)
            if hot + cold:
                rates[f"{verb}_hot_rate"] = hot / (hot + cold)
        if rates:
            stats["tiers"] = {"calls": 0, "msgs": 0, "bytes": 0, **rates}
        return stats

