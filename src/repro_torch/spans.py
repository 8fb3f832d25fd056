"""Spans: named host ranges on the port's query path, for the profiler.

A span is a host range on the profiler's clock: ``torch.profiler``
records it as a CPU operation (not a user annotation), on the same clock
as the device's operations, so a trace places each device operation and
each idle gap inside the program phase that issued it.  It has no
device mirror: unlike ``record_function``, it leaves no range on the
device's timeline, so it never counts as device work.  Its parent is the
span open around it on the same thread, so each query's spans are the
descendants of its one ``db.execute``.

With no profiler running, :func:`span` returns one shared no-op context
(about 0.6 us a span on an H100 host, against 11 us for
``record_function``); under one, a ``_RecordFunctionFast`` of ``name``
(about 2 us).  Names are ``<layer>.<phase>``; :data:`NAMES` lists every span
the port opens.  Nothing here records or exports: the profiler does.
"""
from __future__ import annotations

import contextlib

import torch

NAMES = (
    # facade and planner (db/database.py)
    "db.execute",       # the whole of Database.execute
    "db.plan",          # costing the alternatives and picking one
    "db.run",           # the host issuing the operator's work
    "db.sync",          # waiting for the card to finish it (card only)
    # operators (core/aggregation.py, core/shuffle.py)
    "agg.preagg",       # phase 1: the (pre-)aggregation by key
    "agg.flush",        # RDMA-AGG's route, or Dist-AGG's psum
    "agg.post",         # RDMA-AGG's post-aggregation and all_gather
    "join.route",       # one relation's shuffle to its owner shards
    "join.local",       # the local join and its aggregate
    # fabric (fabric/transport.py)
    "fabric.route",     # count, rank, pack, scatter and unpack
    # kernels (kernels/ops.py): the host's issue of each kernel
    "kernel.rank",
    "kernel.scatter",
    "kernel.grouped_agg",
    "kernel.join",      # the local join and its sum (ops.join_sum)
)

OFF = contextlib.nullcontext()     # every span while no profiler runs

_profiling = torch._C._autograd._profiler_enabled
_Fast = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """The context of the span ``name`` (one of :data:`NAMES`)."""
    return _Fast(name) if _profiling() else OFF
