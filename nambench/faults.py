"""Planted controls and faults: what ``correct`` has to catch.

Each entry is a context manager that patches the program (or puts the
reference in its place) for the length of a run.  The benchmark's own
runs plant nothing; ``controls.py`` runs a plant on the card at a cell's
own size, and the tests run each at a small size on the CPU.

Controls (the reference in the program's place at a lower precision, or
the program with a guarantee switched off):
  ``olap.reference_f32``   every query's answer is the plain reference's,
                           computed with float32 keys and values
  ``oltp.lost_updates``    the commit's CAS grants every request: no
                           write-write conflict and no stale read is
                           detected, so concurrent updates are lost
Faults (one cell has each that it can have; one card has no exchange
between chips to leave out):
  ``olap.half_rows``       the operators see half of each relation
  ``olap.answer_altered``  the aggregate is changed where it is produced
  ``oltp.state_unchanged`` the install writes nothing
  ``oltp.half_batch``      half of each commit batch is left out and
                           reported committed
  ``oltp.answer_altered``  one installed payload word is changed
  ``oltp.facade_retry``    the facade retries its losers itself, which
                           re-reads their versions but keeps the updates
                           they computed from the first read
"""
from __future__ import annotations

import contextlib
import dataclasses
from unittest import mock

import torch

M32 = 0xFFFFFFFF


def _i32(x: int) -> int:
    x &= M32
    return x - (1 << 32) if x >= 1 << 31 else x


@contextlib.contextmanager
def olap_reference_f32():
    from repro_torch.db import Database
    from nambench.reference import olap as reference
    execute = Database.execute

    def replaced(self, plan, **kw):
        res = execute(self, plan, **kw)
        if plan.kind() == "join_agg":
            join = plan.children[0]
            rk, rv = self.table(join.children[0].scan_table()).scan_arrays()
            sk, sv = self.table(join.children[1].scan_table()).scan_arrays()
            v = reference.join_sum(rk, rv, sk, sv, precision="f32")
            value = torch.tensor(_i32(v), dtype=torch.int32,
                                 device=res.value.device)
        else:
            keys, vals = self.table(plan.children[0].scan_table()
                                    ).scan_arrays()
            sums = reference.group_sums(keys, vals, plan.groups,
                                        precision="f32")
            value = torch.where(sums >= 1 << 31, sums - (1 << 32),
                                sums).to(torch.int32)
        return dataclasses.replace(res, value=value)

    with mock.patch.object(Database, "execute", replaced):
        yield


@contextlib.contextmanager
def oltp_lost_updates():
    from repro_torch.core import rsi

    def lock(transport, words, res, r_local, region_ns):
        # every routed request takes its lock: no write-write conflict
        # and no stale read is detected
        return res.valid > 0, words

    with mock.patch.object(rsi, "_lock", lock):
        yield


@contextlib.contextmanager
def olap_half_rows():
    from repro_torch.db.table import Table
    scan = Table.scan_arrays

    def half(self):
        keys, vals = scan(self)
        n = keys.shape[0] // 2
        return keys[:n], vals[:n]

    with mock.patch.object(Table, "scan_arrays", half):
        yield


@contextlib.contextmanager
def olap_answer_altered():
    from repro_torch.core import aggregation, shuffle
    join_agg = shuffle.join_agg
    segment = aggregation.ops.grouped_sum_u32_by_key

    def altered_join(hit, rv, sv):
        return join_agg(hit, rv, sv) + 1

    def altered_sums(*a, **kw):
        out = segment(*a, **kw)
        out[0] += 1
        return out

    with mock.patch.object(shuffle, "join_agg", altered_join), \
            mock.patch.object(aggregation.ops, "grouped_sum_u32_by_key",
                              altered_sums):
        yield


@contextlib.contextmanager
def oltp_state_unchanged():
    from repro_torch.core import rsi

    def install(transport, words, payload, cids, res2, r_local, region_ns):
        return words

    with mock.patch.object(rsi, "_install", install):
        yield


@contextlib.contextmanager
def oltp_half_batch():
    from repro_torch.core import rsi
    from repro_torch.db import database
    commit = rsi.commit

    def half(store, txns, **kw):
        T = txns.write_recs.shape[0]
        k = max(T // 2, 1)
        first = rsi.TxnBatch(*(getattr(txns, f.name)[:k]
                               for f in dataclasses.fields(txns)))
        kw.pop("priority", None)
        ok, store = commit(store, first, **kw)
        rest = torch.ones((T - k,), dtype=torch.bool, device=ok.device)
        return torch.cat([ok, rest]), store

    with mock.patch.dict(database._BACKENDS, {"rsi": half}):
        yield


@contextlib.contextmanager
def oltp_answer_altered():
    from repro_torch.core import rsi
    fields = rsi._install_fields

    def altered(*a):
        inst, act = fields(*a)
        inst["npay"] = inst["npay"].clone()
        inst["npay"][0, 0] += 1
        return inst, act

    with mock.patch.object(rsi, "_install_fields", altered):
        yield


@contextlib.contextmanager
def oltp_facade_retry():
    from repro_torch.db import Database
    commit = Database.commit

    def retried(self, sessions, **kw):
        return commit(self, sessions, **{**kw, "max_retries": 2})

    with mock.patch.object(Database, "commit", retried):
        yield


CONTROLS = {"olap": olap_reference_f32, "oltp": oltp_lost_updates}
FAULTS = {"olap": {"half_rows": olap_half_rows,
                   "answer_altered": olap_answer_altered},
          "oltp": {"state_unchanged": oltp_state_unchanged,
                   "half_batch": oltp_half_batch,
                   "answer_altered": oltp_answer_altered,
                   "facade_retry": oltp_facade_retry}}


def family(kind: str) -> str:
    """The plants that fit a traffic kind: ``olap_*`` or ``oltp_*``."""
    return kind.split("_", 1)[0]


def plant(kind: str, name: str):
    """The context manager of ``name`` ("control" or a fault's name) for
    a cell of traffic ``kind``."""
    fam = family(kind)
    if name == "control":
        return CONTROLS[fam]()
    return FAULTS[fam][name]()
