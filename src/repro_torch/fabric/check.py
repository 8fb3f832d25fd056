"""fabric-check: static analysis for the port's one-sided verb fabric.

The port of ``repro.fabric.check``.  One-sided verbs leave the client
carrying the whole correctness burden: nothing on the far side serializes
conflicting READ/WRITE/CAS accesses, and the hot path's performance rests
on invariants of what a call issues (one exchange per route direction, no
sort, no host transfer, a packed u32 wire).  Two passes share one report
format.

**Pass 1, the op-stream lint** (:func:`lint_fn`).  The JAX package walks a
jaxpr; PyTorch runs eagerly, so the port watches the op stream of one
eager call instead (:class:`OpStream`):

  * a ``TorchDispatchMode`` records every aten op the calling thread
    issues, with the innermost source line of this package that issued
    it (the mode is thread-local: under a ``MeshTransport`` it sees
    shard 0's body, which runs in the caller's thread, and the other
    shards run the same code);
  * the transport's ``exchange``, ``psum`` and ``all_gather``, and the
    exchange a route builds (``_make_exchange``), record the collectives
    the call site issues (shard 0 only, as the transport counts), with
    the tensors handed to each exchange.

Four rules, with the JAX package's meaning:

  * :class:`CollectiveBudget`: exact collective counts per target.  A
    route's exchange counts once per route, however many chunks it
    carries (a chunked route is one ``exchange(v, chunks)`` call; the
    double-buffered route calls its one exchange once a chunk), as JAX
    counts the syntactic site inside its ``scan`` once;
  * :class:`SortFree`: no ``aten::sort`` (``argsort`` and ``msort`` issue
    it too);
  * :class:`NoHostTransfer`: no ``aten::_local_scalar_dense`` (``.item()``,
    ``int(t)``, ``bool(t)``), no device->host copy, and no op whose
    output size the host must read back first (``aten::nonzero``,
    ``aten::masked_select``, ``aten::index``/``index_put_`` with a bool
    index);
  * :class:`PackedWire`: every tensor handed to an exchange is the int32
    bit view of the u32 wire.

A target may declare an **exemption**: a rule whose findings on that
target are reported (``Report.exempted``, printed with the reason) but not
counted as violations.  The port declares one (:data:`EXEMPTIONS`).

**Pass 2, the one-sided race detector** (:class:`ScheduleRecorder` and
:func:`check_schedule`), framework-free and copied from the JAX package:
a recorder on a transport captures per-verb access records and ordering
edges, and the checker reports ``ww-race``, ``rw-race``, ``lost-update``,
``lock-protocol`` and ``staleness`` violations.  The recorder accepts
torch tensors: it copies index tensors to the host while it is attached
(a device->host copy on the card, made only then).

**CLI**: ``python -m repro_torch.fabric.check --figure all -q [--device
cpu]`` lints the hot-path targets on a ``MeshTransport(4)`` and
race-checks eager schedules of the real protocols on a
``LocalTransport``, and ends in ``fabriccheck: N targets, M rules, K
violation(s)``.  The JAX package's ``serve`` suite (and the ``fig_serve``
figure it gates) needs the tiered store and the paged engine, which the
port does not have yet.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch._bits import LOCK_BIT, np_u32, resolve_device

# ---------------------------------------------------------------- report --


@dataclass(frozen=True)
class Violation:
    """One rule breach.  ``where`` is a source line of the port (pass 1)
    or a region (pass 2); ``detail`` names the offending op or verb
    pair."""
    rule: str
    where: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.rule}] {self.where}: {self.detail}"

    def as_dict(self) -> dict:
        return {"rule": self.rule, "where": self.where,
                "detail": self.detail}


@dataclass
class Report:
    """Outcome of one pass over one target.  ``exempted`` holds the
    findings of rules the target is exempt from, each with its reason;
    they do not fail the report."""
    target: str
    rules_run: Tuple[str, ...]
    violations: List[Violation]
    exempted: List[Tuple[Violation, str]] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def render(self) -> str:
        head = f"{'PASS' if self.ok else 'FAIL'} {self.target} " \
               f"(rules: {', '.join(self.rules_run)})"
        lines = [head] + [f"  {v}" for v in self.violations]
        lines += [f"  exempt {v} -- {why}" for v, why in self.exempted]
        return "\n".join(lines)


def summarize(reports: Iterable[Report]) -> dict:
    """Merge reports into one JSON block: ``{rules_run, violations,
    exemptions, targets, ok}``."""
    reports = list(reports)
    rules = sorted({r for rep in reports for r in rep.rules_run})
    vs = [dict(target=rep.target, **v.as_dict())
          for rep in reports for v in rep.violations]
    ex = [dict(target=rep.target, reason=why, **v.as_dict())
          for rep in reports for v, why in rep.exempted]
    return {"rules_run": rules, "violations": vs, "exemptions": ex,
            "targets": [rep.target for rep in reports], "ok": not vs}


# -------------------------------------------- pass 1: the op stream -----

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SELF = os.path.abspath(__file__)


def _site() -> str:
    """The innermost source line of this package (outside this module)
    on the calling thread's stack, as ``fabric/verbs.py:176 (fetch_add)``;
    ``<top>`` when the op came from outside the package."""
    f = sys._getframe(2)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if fn.startswith(_PKG + os.sep) and fn != _SELF:
            rel = os.path.relpath(fn, _PKG)
            return f"{rel}:{f.f_lineno} ({f.f_code.co_name})"
        f = f.f_back
    return "<top>"


@dataclass(frozen=True)
class Op:
    """One aten op of the stream: its schema name (``aten::sort``), where
    it was issued, whether it copies device memory to the host, and
    whether it indexes with a bool mask."""
    name: str
    where: str
    device_to_host: bool = False
    bool_index: bool = False


@dataclass
class Collective:
    """One collective call site: ``kind`` (``all_to_all``, ``psum``,
    ``all_gather``), where it was issued, and the dtypes of the tensors
    handed to it (every call of a route's exchange)."""
    kind: str
    where: str
    dtypes: List[str] = field(default_factory=list)


def _is_device_to_host(name: str, args, kwargs) -> bool:
    """A copy whose source is on an accelerator and whose result is on
    the host: ``_to_copy(x, device=cpu)`` (``.cpu()``, ``.to("cpu")``) or
    ``copy_(cpu_dst, dev_src)``."""
    if name == "aten::_to_copy":
        dst = kwargs.get("device")
        return (dst is not None and torch.device(dst).type == "cpu"
                and args[0].device.type != "cpu")
    if name == "aten::copy_":
        return args[0].device.type == "cpu" and args[1].device.type != "cpu"
    return False


#: ops that index with their ``indices`` list (the second argument)
_INDEX_OPS = frozenset({"aten::index", "aten::index_put",
                        "aten::index_put_", "aten::_index_put_impl_"})
#: ops whose output size depends on the data: the host waits for the
#: device to learn it (on the card, a sync and a device->host copy)
_SIZE_SYNC_OPS = frozenset({"aten::nonzero", "aten::masked_select"})


def _is_bool_index(name: str, args) -> bool:
    """An index op with a bool (or u8) mask among its indices: it runs
    ``nonzero`` on the mask below the dispatcher."""
    return name in _INDEX_OPS and any(
        isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
        for i in (args[1] or ()))


class _Mode(TorchDispatchMode):
    def __init__(self, ops: List[Op]):
        super().__init__()
        self._ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        self._ops.append(Op(name, _site(),
                            _is_device_to_host(name, args, kwargs),
                            _is_bool_index(name, args)))
        return func(*args, **kwargs)


class OpStream:
    """The ops and collectives of one eager call: attach with
    ``with OpStream(transport) as s: fn(...)``.  Observation only: the
    transport's methods are wrapped on the instance for the block and
    restored after."""

    def __init__(self, transport=None):
        self.transport = transport
        self.ops: List[Op] = []
        self.collectives: List[Collective] = []
        self._saved: dict = {}

    def _counted(self) -> bool:
        tp = self.transport
        return tp is None or not tp._quiet()

    def _wrap(self, kind: str, fn, *, exchange: bool):
        def wrapped(x, *a, **kw):
            if self._counted():
                self.collectives.append(Collective(
                    kind, _site(), [str(x.dtype)] if exchange else []))
            return fn(x, *a, **kw)
        return wrapped

    def _wrap_make_exchange(self, make):
        """A route builds one exchange a direction and may call it once a
        chunk: the site counts once, every call's operand is kept."""
        def wrapped(*a, **kw):
            ex = make(*a, **kw)
            if ex is None:
                return None
            site: List[Collective] = []

            def exchange(v):
                if self._counted():
                    if not site:
                        site.append(Collective("all_to_all", _site()))
                        self.collectives.append(site[0])
                    site[0].dtypes.append(str(v.dtype))
                return ex(v)
            return exchange
        return wrapped

    def __enter__(self):
        tp = self.transport
        if tp is not None:
            for name in ("exchange", "psum", "all_gather", "_make_exchange"):
                self._saved[name] = getattr(tp, name)
            tp.exchange = self._wrap("all_to_all", self._saved["exchange"],
                                     exchange=True)
            tp.psum = self._wrap("psum", self._saved["psum"],
                                 exchange=False)
            tp.all_gather = self._wrap("all_gather",
                                       self._saved["all_gather"],
                                       exchange=False)
            tp._make_exchange = self._wrap_make_exchange(
                self._saved["_make_exchange"])
        self._mode = _Mode(self.ops)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        for name in self._saved:
            delattr(self.transport, name)       # back to the class's
        self._saved = {}
        return False


class Rule:
    """A lint rule: ``run(stream) -> [Violation]``."""
    name = "rule"

    def run(self, stream: OpStream) -> List[Violation]:  # pragma: no cover
        raise NotImplementedError


class SortFree(Rule):
    """No sort anywhere in the call: the TPU's weakest op, which the JAX
    fabric's hot paths were rebuilt without."""
    name = "sort-free"

    def run(self, stream):
        return [Violation(self.name, o.where,
                          f"{o.name} in a verb hot path (sort-free "
                          "binning/arbitration is the contract)")
                for o in stream.ops if o.name == "aten::sort"]


class CollectiveBudget(Rule):
    """Exact collective counts per call, e.g. ``{"all_to_all": 1}`` for
    one routed direction.  A route's exchange counts once however many
    chunks it carries."""
    name = "collective-budget"

    def __init__(self, budget: Dict[str, int]):
        self.budget = dict(budget)

    def run(self, stream):
        out = []
        for kind, want in self.budget.items():
            got = sum(1 for c in stream.collectives if c.kind == kind)
            if got != want:
                out.append(Violation(
                    self.name, "<top>",
                    f"{got} {kind} site(s) issued, budget is {want}"))
        return out


class NoHostTransfer(Rule):
    """No host sync in a verb call: no ``_local_scalar_dense`` (a scalar
    read by the host), no device->host copy, and no op whose output size
    the host must read from the device (``nonzero``, ``masked_select``, a
    bool-mask index).  The NAM hot path must stay on the device."""
    name = "no-host-transfer"

    def run(self, stream):
        return [Violation(self.name, o.where,
                          f"host transfer '{o.name}'"
                          + (" (device->host copy)" if o.device_to_host
                             else " (bool-mask index)" if o.bool_index
                             else "") + " inside a verb call")
                for o in stream.ops
                if o.name == "aten::_local_scalar_dense"
                or o.name in _SIZE_SYNC_OPS or o.device_to_host
                or o.bool_index]


class PackedWire(Rule):
    """Everything handed to an exchange is the packed u32 wire, carried as
    its int32 bit view: a raw leaf on the exchange means someone bypassed
    ``pack_fields``."""
    name = "packed-wire"

    def run(self, stream):
        return [Violation(self.name, c.where,
                          f"{c.kind} operand dtype {dt} is not the packed "
                          "u32 wire (int32 bit view)")
                for c in stream.collectives if c.kind == "all_to_all"
                for dt in c.dtypes if dt != "torch.int32"]


#: the standing hot-path rule set; targets add their CollectiveBudget.
HOT_PATH_RULES: Tuple[Rule, ...] = (SortFree(), NoHostTransfer(),
                                    PackedWire())


def lint_fn(fn: Callable, *args, rules: Iterable[Rule],
            transport=None, target: Optional[str] = None,
            exempt: Optional[Dict[str, str]] = None) -> Report:
    """Call ``fn(*args)`` once, eagerly, watching its op stream (and the
    collectives of ``transport``), and lint it.  ``exempt`` maps a rule
    name to the reason its findings on this target are exempt."""
    rules = tuple(rules)
    exempt = dict(exempt or {})
    with OpStream(transport) as stream:
        fn(*args)
    vs, ex = [], []
    for r in rules:
        for v in r.run(stream):
            if r.name in exempt:
                ex.append((v, exempt[r.name]))
            else:
                vs.append(v)
    return Report(target or getattr(fn, "__name__", "<fn>"),
                  tuple(r.name for r in rules), vs, ex)


# ------------------------------------- pass 2: the schedule recorder -----

READ, WRITE, CAS, FETCH_ADD = "READ", "WRITE", "CAS", "FETCH_ADD"
ATOMICS = frozenset({CAS, FETCH_ADD})
#: verbs whose completion the issuing agent must await before using the
#: result: recording one fences that agent (a one-sided round trip).
_COMPLETION_VERBS = frozenset({READ, CAS, FETCH_ADD})


def _concrete(x) -> Optional[np.ndarray]:
    """``x`` as a host numpy array (a torch tensor is copied to the host:
    a device->host copy on the card, made only while a recorder is
    attached), or None."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    try:
        return np.asarray(x)
    except Exception:
        return None


@dataclass
class Access:
    """One recorded verb access: who touched which rows of which region,
    in which round (global-fence epoch) and commit wave."""
    seq: int
    verb: str
    region: str
    lo: int
    hi: int                       # [lo, hi) row interval
    rows: Optional[np.ndarray]    # concrete touched rows; None = whole
                                  # interval
    agent: str
    wave: int
    gfence: int                   # global fences seen before this access
    afence: int                   # this agent's local fences before it
    meta: dict = field(default_factory=dict)

    def describe(self) -> str:
        return (f"{self.verb}#{self.seq}(agent={self.agent}, "
                f"round={self.gfence})")


@dataclass(frozen=True)
class Fence:
    """One ordering edge of the happens-before graph: everything recorded
    before it happens-before everything after (global scope) or
    everything the same agent records after (local scope)."""
    seq: int                      # position in the access stream
    kind: str                     # route-roundtrip | read-completion | ...
    scope: Optional[str]          # None = global barrier, else agent name


def _intersect(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The common rows of two sorted unique row arrays, in
    O(small * log(large)) (``np.intersect1d`` sorts both)."""
    if a.size > b.size:
        a, b = b, a
    if a.size == 0:
        return a
    pos = np.minimum(np.searchsorted(b, a), b.size - 1)
    return a[b[pos] == a]


def _overlap(a: Access, b: Access):
    """Overlapping rows of two same-region accesses, printable, or None."""
    if a.region != b.region:
        return None
    if a.rows is not None and b.rows is not None:
        inter = _intersect(a.rows, b.rows)
        return _fmt_rows(inter) if inter.size else None
    lo, hi = max(a.lo, b.lo), min(a.hi, b.hi)
    return f"rows {lo}:{hi}" if hi > lo else None


def _fmt_rows(rows: np.ndarray) -> str:
    rows = np.asarray(rows).ravel()
    if rows.size == 0:
        return "rows {}"
    if rows.size > 8:
        return f"rows {int(rows.min())}:{int(rows.max()) + 1} " \
               f"({rows.size} rows)"
    return "rows {" + ", ".join(str(int(r)) for r in rows) + "}"


class ScheduleRecorder:
    """Opt-in verb-schedule recorder for a fabric transport.

    Attach with ``Transport(recorder=ScheduleRecorder())``; verbs called
    with a ``region=`` name then append :class:`Access` records, and
    synchronization points append :class:`Fence` edges:

      * ``route()`` / ``exchange()`` / ``psum`` / ``all_gather``: global
        fences (a routed round trip synchronizes every agent's view);
      * READ / CAS / FETCH_ADD: local fences for the issuing agent;
      * a FETCH_ADD on a region declared with :meth:`declare_epoch`: an
        additional global fence (the epoch bump publishes every write
        before it: the parameter server's version clock);
      * plain WRITE: no fence; the races unsignaled one-sided writes
        enable are what :func:`check_schedule` hunts.

    ``agent(name)`` scopes accesses to a logical issuer; ``begin_wave()``
    advances the commit-wave counter the lock-protocol rule checks
    acquisitions against.  Under a ``MeshTransport`` only shard 0 records,
    with shard 0's local rows.
    """

    def __init__(self):
        self.accesses: List[Access] = []
        self.notes: List[dict] = []
        self.fences: List[Fence] = []
        self._gfence = 0
        self._afence: Dict[str, int] = {}
        self._agents: List[str] = ["main"]
        self._wave = 0
        self.lock_protocols: Dict[str, dict] = {}
        self.epoch_protocols: Dict[str, dict] = {}

    # -------------------------------------------------- declarations ----

    def declare_locks(self, lock_region: str, protected: Iterable[str],
                      *, lock_bit: int = 1 << 31):
        """Declare ``lock_region`` a lock-word column guarding the row
        spaces of ``protected`` regions: a successful CAS installing a
        word with ``lock_bit`` set acquires that row for the current wave;
        an install WRITE to a protected row outside the acquiring wave is
        a ``lock-protocol`` violation."""
        self.lock_protocols[lock_region] = {
            "protected": tuple(protected), "bit": int(lock_bit)}

    def declare_epoch(self, epoch_region: str, *, params_region: str,
                      staleness: int):
        """Declare ``epoch_region`` a version clock for ``params_region``
        with bounded staleness ``k``: FETCH_ADDs on it become global
        publication fences, and pulls noted with :meth:`note_pull` must
        observe an epoch >= current - k."""
        self.epoch_protocols[epoch_region] = {
            "params_region": params_region, "staleness": int(staleness)}

    # ---------------------------------------------------- structure -----

    @property
    def current_agent(self) -> str:
        return self._agents[-1]

    @contextmanager
    def agent(self, name: str):
        """Attribute accesses inside the block to logical agent ``name``."""
        self._agents.append(str(name))
        try:
            yield self
        finally:
            self._agents.pop()

    def begin_wave(self, label: Optional[str] = None) -> int:
        self._wave += 1
        if label:
            self.note("wave", wave=self._wave, label=label)
        return self._wave

    def fence(self, kind: str = "fence", *, local: bool = False,
              agent: Optional[str] = None):
        """Record an ordering edge: a global barrier (default) or a local
        completion fence for the current agent (or for ``agent``: a
        deferred ``Completion.wait()`` may fire outside the block that
        issued the verb)."""
        scope = (str(agent) if agent is not None
                 else self.current_agent) if local else None
        if local:
            self._afence[scope] = self._afence.get(scope, 0) + 1
        else:
            self._gfence += 1
        self.fences.append(Fence(len(self.accesses), kind, scope))

    # ------------------------------------------------------- events -----

    def record(self, verb: str, region: str, idx, *,
               region_len: Optional[int] = None, ok=None, new=None,
               meta: Optional[dict] = None,
               deferred: bool = False) -> Access:
        """Append one verb access.  CAS records on a declared lock region
        also compute the acquired row set (rows where the CAS succeeded
        installing the lock bit).  ``deferred=True`` (the async verbs)
        withholds the completion fence; it fires at ``Completion.wait()``
        through :meth:`complete`."""
        cidx = _concrete(idx)
        if cidx is not None:
            cidx = cidx.reshape(-1).astype(np.int64)
            rows = np.unique(cidx[cidx >= 0])
            lo, hi = ((int(rows.min()), int(rows.max()) + 1) if rows.size
                      else (0, 0))
        else:
            rows = None
            lo, hi = 0, int(region_len) if region_len else (1 << 62)
        meta = dict(meta or {})
        if verb == CAS and region in self.lock_protocols:
            bit = self.lock_protocols[region]["bit"]
            cok, cnew = _concrete(ok), _concrete(new)
            if cidx is not None and cok is not None and cnew is not None:
                acq = cidx[(cidx >= 0) & cok.reshape(-1).astype(bool)
                           & ((cnew.reshape(-1).astype(np.int64) & bit)
                              != 0)]
                meta["acquired"] = np.unique(acq)
        a = Access(seq=len(self.accesses), verb=verb, region=str(region),
                   lo=lo, hi=hi, rows=rows, agent=self.current_agent,
                   wave=self._wave, gfence=self._gfence,
                   afence=self._afence.get(self.current_agent, 0),
                   meta=meta)
        self.accesses.append(a)
        if not deferred:
            if verb in _COMPLETION_VERBS:
                self.fence(f"{verb.lower()}-completion", local=True)
            if verb == FETCH_ADD and region in self.epoch_protocols:
                self.fence("epoch-publish")
        return a

    def complete(self, access: Access):
        """Fire the deferred completion edge of an async verb: a local
        fence for the issuing agent (a waited WRITE becomes a signaled
        write), plus the epoch publication of a FETCH_ADD on a declared
        epoch region."""
        self.fence(f"{access.verb.lower()}-completion", local=True,
                   agent=access.agent)
        if access.verb == FETCH_ADD \
                and access.region in self.epoch_protocols:
            self.fence("epoch-publish")

    def note(self, kind: str, **meta):
        """Append a semantic (non-verb) event, e.g. a PS pull."""
        self.notes.append({"kind": kind, "seq": len(self.accesses), **meta})

    def note_pull(self, *, region: str, worker, observed_epoch: int,
                  current_epoch: int, staleness: int):
        """Record a bounded-stale parameter pull: the epoch the worker's
        served view carries against the clock's current value."""
        self.note("ps_pull", region=str(region), worker=worker,
                  observed=int(observed_epoch), current=int(current_epoch),
                  staleness=int(staleness))

    # ----------------------------------------------- happens-before -----

    def happens_before(self, a: Access, b: Access) -> bool:
        """a -> b iff a global fence separates them, or they share an
        agent and a local completion fence does."""
        if a.seq >= b.seq:
            return False
        return a.gfence < b.gfence or (a.agent == b.agent
                                       and a.afence < b.afence)

    def concurrent(self, a: Access, b: Access) -> bool:
        return not self.happens_before(a, b) \
            and not self.happens_before(b, a)

    def summary(self) -> dict:
        return {"accesses": len(self.accesses), "fences": len(self.fences),
                "waves": self._wave, "notes": len(self.notes),
                "regions": sorted({a.region for a in self.accesses})}


SCHEDULE_RULES = ("ww-race", "rw-race", "lost-update", "lock-protocol",
                  "staleness")


def check_schedule(rec: ScheduleRecorder, *,
                   target: str = "schedule") -> Report:
    """Race-check a recorded schedule: pairwise conflicts with no
    happens-before path, lost updates around atomics, lock-protocol
    violations and staleness-bound breaches.  Every violation names the
    offending verb pair (``VERB#seq``) and the region."""
    vs: List[Violation] = []
    seen = set()

    def emit(rule, region, detail, *seqs):
        key = (rule, region, tuple(sorted(seqs, key=str)))
        if key not in seen:
            seen.add(key)
            vs.append(Violation(rule, region, detail))

    by_region: Dict[str, List[Access]] = {}
    for a in rec.accesses:
        by_region.setdefault(a.region, []).append(a)

    # every rule of the pairwise pass needs a WRITE in the pair: a
    # non-WRITE access is paired with the later WRITEs only (the pairs
    # come in the same order, so the same violations)
    for region, accs in by_region.items():
        writes = [i for i, a in enumerate(accs) if a.verb == WRITE]
        for i, a in enumerate(accs):
            if a.verb == WRITE:
                later = accs[i + 1:]
            else:
                later = [accs[j] for j in
                         writes[bisect.bisect_right(writes, i):]]
            for b in later:
                if not rec.concurrent(a, b):
                    continue
                ov = _overlap(a, b)
                if ov is None:
                    continue
                pair = (a.verb, b.verb)
                if pair == (WRITE, WRITE):
                    emit("ww-race", region,
                         f"{a.describe()} || {b.describe()} on '{region}' "
                         f"{ov}: overlapping WRITEs with no ordering path",
                         a.seq, b.seq)
                elif READ in pair and WRITE in pair:
                    emit("rw-race", region,
                         f"{a.describe()} || {b.describe()} on '{region}' "
                         f"{ov}: READ concurrent with an unordered WRITE",
                         a.seq, b.seq)
                elif WRITE in pair and (a.verb in ATOMICS
                                        or b.verb in ATOMICS):
                    w, c = (a, b) if a.verb == WRITE else (b, a)
                    emit("lost-update", region,
                         f"plain {w.describe()} racing atomic "
                         f"{c.describe()} on '{region}' {ov}: the plain "
                         "WRITE can overwrite the atomic's update",
                         a.seq, b.seq)

    # lost updates around a plain RMW window: READ ->hb-> WRITE by one
    # agent, an atomic lands with no ordering into that window.
    for region, accs in by_region.items():
        atomics = [c for c in accs if c.verb in ATOMICS]
        if not atomics:
            continue
        writes = [w for w in accs if w.verb == WRITE]
        for r in accs:
            if r.verb != READ:
                continue
            for w in writes:
                if (w.agent != r.agent
                        or not rec.happens_before(r, w)
                        or _overlap(r, w) is None):
                    continue
                for c in atomics:
                    ov = _overlap(c, w)
                    if ov is None:
                        continue
                    if (c.agent == r.agent and rec.happens_before(r, c)
                            and rec.happens_before(c, w)):
                        # the agent's own atomic inside its READ->WRITE
                        # window: the writer holds the CAS result, so
                        # nothing is lost unknowingly (the retry loop's
                        # refresh READ -> prepare CAS -> install WRITE)
                        continue
                    if not rec.happens_before(c, r) \
                            and not rec.happens_before(w, c):
                        emit("lost-update", region,
                             f"RMW {r.describe()} -> {w.describe()} by "
                             f"'{r.agent}' on '{region}' with concurrent "
                             f"{c.describe()} {ov}: the read-modify-write "
                             "loses the atomic's update",
                             r.seq, w.seq, c.seq)

    # lock protocol: install WRITEs to protected rows must be covered by a
    # CAS lock acquisition in the same wave.
    for lock_region, proto in rec.lock_protocols.items():
        protected = set(proto["protected"])
        held: Dict[int, set] = {}
        for a in rec.accesses:
            if a.verb == CAS and a.region == lock_region:
                acq = a.meta.get("acquired")
                if acq is not None:
                    held.setdefault(a.wave, set()).update(int(r)
                                                          for r in acq)
            elif a.verb == WRITE and a.region in protected:
                if a.rows is None:
                    continue
                bad = [int(r) for r in a.rows
                       if int(r) not in held.get(a.wave, set())]
                if bad:
                    emit("lock-protocol", a.region,
                         f"install {a.describe()} to '{a.region}' "
                         f"{_fmt_rows(np.asarray(bad))} in wave {a.wave}: "
                         f"lock word in '{lock_region}' was not "
                         "CAS-acquired by that session wave",
                         a.seq, a.wave)

    # staleness: every noted pull must observe epoch >= current - k.
    for n in rec.notes:
        if n["kind"] != "ps_pull":
            continue
        lag = n["current"] - n["observed"]
        if lag > n["staleness"]:
            emit("staleness", n["region"],
                 f"pull by worker '{n['worker']}' observed epoch "
                 f"{n['observed']} at current epoch {n['current']} on "
                 f"'{n['region']}': lag {lag} exceeds the bounded-"
                 f"staleness k={n['staleness']}",
                 ("pull", n["seq"], n["worker"]))

    return Report(target, SCHEDULE_RULES, vs)


# ------------------------------------------------ canned lint targets ----

ROUTE_CAP = 32
MESH_SHARDS = 4          # the lint targets run on MeshTransport(4)

#: rules a target is exempt from, with the reason (printed in its report).
EXEMPTIONS: Dict[str, Dict[str, str]] = {
    "verbs/fetch_add": {
        "sort-free": "the port's FETCH_ADD takes its per-word exclusive "
                     "prefix with a stable sort; ROADMAP's ground rule "
                     "lets an H100 path sort as long as its output equals "
                     "the reference's (the sort-free O(A^2) form is a TPU "
                     "choice)"},
}


def _mesh_transport(device=None):
    from repro_torch.fabric import MeshTransport
    return MeshTransport(MESH_SHARDS, "fabric", device=device)


def lint_route(num_fields: int = 3, *, chunks: int = 1,
               response: bool = False, window: int = 0,
               overlap: bool = False, device=None) -> Report:
    """Lint one routed direction (plus optionally the paired response
    exchange) on a mesh transport: budget 1 all_to_all out (+1 back),
    sort-free, host-free, packed wire.  ``window`` routes with a
    doorbell-batching cap: still the same single exchange.  ``overlap``
    lints the double-buffered chunk pipeline under the same budget."""
    dev = resolve_device(device)
    tp = _mesh_transport(dev)

    def body(*leaves):
        fields = {f"f{i}": leaf for i, leaf in enumerate(leaves)}
        dest = leaves[0] % tp.n
        res = tp.route(fields, dest, cap=ROUTE_CAP, chunks=chunks,
                       window=window or None, overlap=overlap)
        tot = sum(leaf.sum() for leaf in res.fields.values())
        if response:
            grant = tp.exchange(res.valid.to(torch.int32))
            tot = tot + grant.sum()
        return tot

    args = tuple(torch.ones((16,), dtype=torch.int32, device=dev)
                 for _ in range(num_fields))
    budget = CollectiveBudget({"all_to_all": 2 if response else 1})
    name = (f"route[{num_fields}f,chunks={chunks}"
            + (",response" if response else "")
            + (f",window={window}" if window else "")
            + (",overlap" if overlap else "") + "]")
    return lint_fn(lambda *a: tp.run(body, a, out_reps=True), *args,
                   rules=HOT_PATH_RULES + (budget,), transport=tp,
                   target=name)


def lint_verbs(device=None) -> List[Report]:
    """Lint the atomic verbs: sort-free, host-free, zero collectives
    (arbitration is local work)."""
    from repro_torch.fabric import verbs
    dev = resolve_device(device)

    def words():
        return torch.zeros((64,), dtype=torch.int32, device=dev)
    idx = torch.tensor([0, 1, 1, -1], dtype=torch.int32, device=dev)
    u = torch.ones((4,), dtype=torch.int32, device=dev)
    rules = HOT_PATH_RULES + (CollectiveBudget({"all_to_all": 0}),)
    return [lint_fn(lambda w: verbs.cas(w, idx, u, u), words(),
                    rules=rules, target="verbs/cas"),
            lint_fn(lambda w: verbs.fetch_add(w, idx, u), words(),
                    rules=rules, target="verbs/fetch_add",
                    exempt=EXEMPTIONS["verbs/fetch_add"])]


#: all_to_all sites in ONE commit wave: prepare route + grant exchange +
#: install route (the install reuses the prepare's RoutePlan, so a fourth
#: site would mean the plan-reuse contract broke).
COMMIT_ALL_TO_ALL_BUDGET = 3


def commit_all_to_all_budget(waves: int = 1) -> int:
    """Collective budget of a commit of ``waves`` (possibly pipelined)
    transaction waves: each wave has its own prepare route, grant
    exchange and install route."""
    return COMMIT_ALL_TO_ALL_BUDGET * int(waves)


def _txns(t: int, first_cid: int, dev, w: int = 2, m: int = 2):
    from repro_torch.core import rsi
    return rsi.TxnBatch(
        write_recs=torch.zeros((t, w), dtype=torch.int32, device=dev),
        read_cids=torch.zeros((t, w), dtype=torch.int32, device=dev),
        new_payload=torch.zeros((t, w, m), dtype=torch.int32, device=dev),
        cid=torch.arange(first_cid, first_cid + t, dtype=torch.int32,
                         device=dev))


def _store(num_timestamps: int, dev):
    from repro_torch.core import rsi
    return rsi.init_store(rsi.StoreCfg(num_records=16, payload_words=2,
                                       num_timestamps=num_timestamps),
                          device=dev)


def lint_commit(protocol: str = "rsi", device=None) -> Report:
    """Lint a full commit wave (4 txns, one a shard) on a mesh transport."""
    from repro_torch.core import rsi, twopc
    dev = resolve_device(device)
    tp = _mesh_transport(dev)
    commit = {"rsi": rsi.commit, "2pc": twopc.commit}[protocol]
    rules = HOT_PATH_RULES + (
        CollectiveBudget({"all_to_all": commit_all_to_all_budget(1)}),)
    return lint_fn(lambda s, t: commit(s, t, transport=tp), _store(32, dev),
                   _txns(4, 0, dev), rules=rules, transport=tp,
                   target=f"{protocol}.commit")


def lint_commit_pipelined(waves: int = 2, device=None) -> Report:
    """Lint the pipelined commit: 3 all_to_all sites a wave, sort-free,
    host-free, packed wire."""
    from repro_torch.core import rsi
    dev = resolve_device(device)
    tp = _mesh_transport(dev)
    wv = [_txns(4, 4 * i, dev) for i in range(waves)]
    rules = HOT_PATH_RULES + (
        CollectiveBudget({"all_to_all": commit_all_to_all_budget(waves)}),)
    return lint_fn(lambda s, w: rsi.commit_pipelined(s, w, transport=tp),
                   _store(32, dev), wv, rules=rules, transport=tp,
                   target=f"rsi.commit_pipelined[waves={waves}]")


def lint_commit_grouped(groups: int = 3, device=None) -> Report:
    """Lint the group commit: K coalesced session batches are still ONE
    commit wave, 3 all_to_all sites in all.  Each group holds 4
    transactions (the JAX target's 2 do not split over 4 shards)."""
    from repro_torch.core import rsi
    dev = resolve_device(device)
    tp = _mesh_transport(dev)
    gs = [_txns(4, 4 * g, dev) for g in range(groups)]
    rules = HOT_PATH_RULES + (
        CollectiveBudget({"all_to_all": commit_all_to_all_budget(1)}),)
    return lint_fn(lambda s, g: rsi.commit_grouped(s, g, transport=tp),
                   _store(64, dev), gs, rules=rules, transport=tp,
                   target=f"rsi.commit_grouped[groups={groups}]")


def lint_ps_push(device=None) -> Report:
    """Lint the parameter server's routed push body: one all_to_all,
    packed wire, sort-free."""
    from repro_torch.analytics import ParameterServer
    dev = resolve_device(device)
    tp = _mesh_transport(dev)
    params = {"w": torch.zeros((16, 8), dtype=torch.float32, device=dev)}
    ps = ParameterServer(params, transport=tp, block=8, num_shards=4)
    S, L = ps.num_shards, ps.shard_len
    codes = torch.zeros((S, L), dtype=torch.int8, device=dev)
    scale = torch.zeros((S, L // ps.block), dtype=torch.float32,
                        device=dev)
    rules = HOT_PATH_RULES + (CollectiveBudget({"all_to_all": 1}),)
    return lint_fn(lambda c, s: tp.run(ps._push_body, (c, s), False),
                   codes, scale, rules=rules, transport=tp,
                   target="paramserver.push")


# -------------------------------------- canned protocol race schedules ---


def _recording(device):
    from repro_torch.fabric import LocalTransport
    rec = ScheduleRecorder()
    return rec, LocalTransport(recorder=rec, device=resolve_device(device))


def _acct(db, rec):
    t = db.create_table("acct", 32, payload_words=2, num_timestamps=128)
    t.seed(np.arange(8), vals=np.ones((8, 2), np.uint32))
    rec.declare_locks("acct/words", ("acct/payload", "acct/cids"),
                      lock_bit=LOCK_BIT & 0xFFFFFFFF)
    return t


def record_session_waves(isolation: str = "rsi",
                         device=None) -> ScheduleRecorder:
    """Run real session waves (conflicting writers, snapshot reads, a
    serving-style lock table) through a recording transport and return
    the schedule."""
    from repro_torch.db import Database
    rec, tp = _recording(device)
    db = Database(tp)
    _acct(db, rec)
    # wave 1: two sessions, record 1 contended
    s1, s2 = db.session(isolation), db.session(isolation)
    s1.begin()
    pay, rc, _ = s1.get("acct", [0, 1])
    s1.put("acct", [0, 1], np_u32(pay) + 1, read_cids=np_u32(rc))
    s2.begin()
    pay2, rc2, _ = s2.get("acct", [1, 2])
    s2.put("acct", [1, 2], np_u32(pay2) + 2, read_cids=np_u32(rc2))
    db.commit([s1, s2])
    # wave 2: a fresh snapshot read + a disjoint commit
    s3 = db.session(isolation).begin()
    pay3, rc3, _ = s3.get("acct", [3])
    s3.put("acct", [3], np_u32(pay3) + 3, read_cids=np_u32(rc3))
    db.commit([s3])
    db.snapshot_read("acct", [0, 1, 2, 3])
    # the serving pattern: decode-slot claims on a dedicated lock table
    slots = db.create_table("slots", 4, payload_words=1, num_timestamps=8)
    for row in slots.claim_locks(2, tag=1):
        slots.release_lock(row)
    return rec


def record_paramserver(staleness: int = 2, steps: int = 3,
                       workers: int = 2, device=None) -> ScheduleRecorder:
    """Run the PS trainer loop (ticket claims off the decentralized queue,
    bounded-stale pulls, compressed routed pushes) through a recording
    transport and return the schedule."""
    from repro_torch.analytics import ParameterServer
    from repro_torch.core import workqueue
    from repro_torch.tree import tree_map
    rec, tp = _recording(device)
    dev = tp.device
    params = {"w": torch.ones((8, 4), dtype=torch.float32, device=dev),
              "b": torch.zeros((4,), dtype=torch.float32, device=dev)}
    ps = ParameterServer(params, transport=tp, staleness=staleness,
                         block=8, num_shards=4)
    head = torch.zeros((1,), dtype=torch.int32, device=dev)
    for _ in range(steps):
        _, head = workqueue.claim_ticket_ranges(
            head, torch.ones((workers,), dtype=torch.int32, device=dev),
            transport=tp)
        for w in range(workers):
            view, _ = ps.pull(worker=w)
            grads = tree_map(lambda p: torch.full_like(p, 0.01 * (w + 1)),
                             view)
            ps.push(grads, worker=w)
    return rec


def record_windowed_route(device=None) -> ScheduleRecorder:
    """A producer's WRITEs, a windowed route, a consumer's READs: the
    windowed route is still one round trip, a global fence, so the
    cross-agent write->read pairs record clean."""
    rec, tp = _recording(device)
    dev = tp.device
    words = torch.zeros((64,), dtype=torch.int32, device=dev)
    idx = torch.arange(8, dtype=torch.int32, device=dev)
    with rec.agent("producer"):
        words = tp.write(words, idx, torch.ones((8,), dtype=torch.int32,
                                                device=dev),
                         region="sim/buf")
    plan = tp.plan_route(idx % tp.n, cap=16, window=4)
    tp.route({"k": words[:8]}, plan=plan)       # windowed global fence
    with rec.agent("consumer"):
        tp.read(words, idx, region="sim/buf")
    return rec


def record_overlapped_route(device=None) -> ScheduleRecorder:
    """The double-buffered route schedule: a producer's async WRITE
    (waited: a signaled write), an async overlapped route, and the
    consumer's READ only after ``Completion.wait()``, which is the
    route-roundtrip fence: clean."""
    rec, tp = _recording(device)
    dev = tp.device
    words = torch.zeros((64,), dtype=torch.int32, device=dev)
    idx = torch.arange(8, dtype=torch.int32, device=dev)
    with rec.agent("producer"):
        wc = tp.write_async(words, idx, torch.ones((8,), dtype=torch.int32,
                                                   device=dev),
                            region="async/buf")
        words = wc.wait()                    # signaled write completion
    plan = tp.plan_route(idx % tp.n, cap=16, window=4)
    c = tp.route_async({"k": words[:8]}, plan=plan, chunks=2)
    c.wait()                                 # route-roundtrip fence
    with rec.agent("consumer"):
        tp.read(words, idx, region="async/buf")
    return rec


def record_pipelined_commit(waves: int = 2,
                            device=None) -> ScheduleRecorder:
    """Run the pipelined RSI commit (wave i's install round overlapping
    wave i+1's prepare) with the lock protocol declared: every install
    WRITE stays inside its acquiring wave."""
    from repro_torch.db import Database
    rec, tp = _recording(device)
    db = Database(tp)
    _acct(db, rec)
    wave_list = []
    for wv in range(waves):
        s = db.session().begin()
        recs = [2 * wv, 2 * wv + 1]
        pay, rc, _ = s.get("acct", recs)
        s.put("acct", recs, np_u32(pay) + 1, read_cids=np_u32(rc))
        wave_list.append([s])
    db.commit_pipelined(wave_list)
    return rec


def record_grouped_commit(max_retries: int = 1,
                          device=None) -> ScheduleRecorder:
    """A contended group commit with bounded retry: two groups hit the
    same hot row, the loser retries, and its refresh READ comes after the
    wave's commit-complete fence, so the schedule records clean."""
    from repro_torch.db import Database
    rec, tp = _recording(device)
    db = Database(tp)
    _acct(db, rec)
    groups = []
    for w in range(2):
        s = db.session().begin()
        recs = [0, 4 + w]                   # record 0 is the hot row
        pay, rc, _ = s.get("acct", recs)
        s.put("acct", recs, np_u32(pay) + w + 1, read_cids=np_u32(rc))
        groups.append([s])
    db.commit_grouped(groups, max_retries=max_retries)
    return rec


def race_sessions(isolation: str = "rsi", device=None) -> Report:
    return check_schedule(record_session_waves(isolation, device),
                          target=f"sessions/{isolation}")


def race_windowed_route(device=None) -> Report:
    return check_schedule(record_windowed_route(device),
                          target="route/windowed")


def race_paramserver(device=None) -> Report:
    return check_schedule(record_paramserver(device=device),
                          target="paramserver/trainer")


def race_overlapped_route(device=None) -> Report:
    return check_schedule(record_overlapped_route(device),
                          target="route/overlapped")


def race_pipelined_commit(waves: int = 2, device=None) -> Report:
    return check_schedule(record_pipelined_commit(waves, device),
                          target=f"rsi/pipelined[waves={waves}]")


def race_grouped_commit(max_retries: int = 1, device=None) -> Report:
    return check_schedule(record_grouped_commit(max_retries, device),
                          target=f"rsi/grouped[retries={max_retries}]")


# ------------------------------------------------------- CLI plumbing ----

#: each suite takes the device.  The JAX package's "serve" suite is not
#: here: it needs the tiered store and the paged engine (ROADMAP queue 1
#: item 7).
SUITES: Dict[str, Callable[..., List[Report]]] = {
    "route": lambda d: [lint_route(1, device=d), lint_route(5, device=d),
                        lint_route(3, chunks=4, device=d),
                        lint_route(2, response=True, device=d)],
    "verbs": lambda d: lint_verbs(d),
    "rsi": lambda d: [lint_commit("rsi", d), race_sessions("rsi", d)],
    "2pc": lambda d: [lint_commit("2pc", d), race_sessions("2pc", d)],
    "paramserver": lambda d: [lint_ps_push(d), race_paramserver(d)],
    # the windowed route stays one exchange, and the write -> windowed
    # route -> read schedule records clean
    "sim": lambda d: [lint_route(2, window=4, device=d),
                      lint_route(3, chunks=2, window=2, device=d),
                      race_windowed_route(d)],
    # the overlapped chunk pipeline keeps the one-exchange budget, the
    # pipelined commit is 3 sites a wave, and the async schedules record
    # clean under their Completion.wait() fences
    "async": lambda d: [lint_route(3, chunks=4, overlap=True, device=d),
                        lint_route(2, response=True, overlap=True,
                                   device=d),
                        lint_commit_pipelined(2, d),
                        race_overlapped_route(d),
                        race_pipelined_commit(2, d)],
    # K coalesced sessions stay inside one wave's 3-collective budget, and
    # the contended grouped schedule records clean
    "scale": lambda d: [lint_commit_grouped(3, d),
                        lint_commit_grouped(1, d),
                        race_grouped_commit(1, d)],
}

#: which check suites gate each paper figure (fig_serve needs "serve").
FIGURE_SUITES: Dict[str, Tuple[str, ...]] = {
    "fig2": ("verbs", "route"),
    "fig6": ("rsi", "2pc"),
    "fig7": ("route",),
    "fig8a": ("route", "async"),
    "fig8b": ("route", "verbs"),
    "fig9": ("paramserver", "route"),
    "fig10": ("sim", "route"),
    "fig_scale": ("scale", "rsi"),
}


def run_suite(name: str, device=None) -> List[Report]:
    return list(SUITES[name](device))


def check_figure(figure: str, device=None) -> List[Report]:
    """All reports gating one figure (suites may repeat across figures;
    each run is independent)."""
    return [rep for s in FIGURE_SUITES[figure]
            for rep in run_suite(s, device)]


def check_all(device=None) -> List[Report]:
    """Every suite once."""
    return [rep for s in SUITES for rep in run_suite(s, device)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="fabriccheck",
        description="fabric-check: op-stream lint + one-sided race "
                    "detector for the port's verb fabric")
    ap.add_argument("--figure", default=None,
                    choices=sorted(FIGURE_SUITES) + ["all"],
                    help="check the suites gating one figure, or every "
                         "suite once ('all')")
    ap.add_argument("--suite", default=None, choices=sorted(SUITES),
                    help="run a single named suite")
    ap.add_argument("--device", default=None,
                    help="where the checked calls run (default: the card)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the merged summary JSON here")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="only print failures, exemptions and the final "
                         "line")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.suite:
        reports = run_suite(args.suite, dev)
    elif args.figure and args.figure != "all":
        reports = check_figure(args.figure, dev)
    else:
        reports = check_all(dev)
    for rep in reports:
        if not rep.ok or rep.exempted or not args.quiet:
            print(rep.render())
    summ = summarize(reports)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summ, f, indent=2, sort_keys=True)
        print(f"wrote {args.json}", file=sys.stderr)
    n_bad = len(summ["violations"])
    print(f"fabriccheck: {len(reports)} targets, "
          f"{len(summ['rules_run'])} rules, {n_bad} violation(s)")
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
