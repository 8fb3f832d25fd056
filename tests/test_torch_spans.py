"""The port's spans (``repro_torch.spans``) on the query path, on the CPU:

  * with no profiler running, ``span`` hands back the one shared no-op;
  * under ``torch.profiler`` (CPU activity), each OLAP variant's query
    through ``Database(device="cpu")`` opens its spans as the nested tree
    ``db.execute`` > ``db.plan``, ``db.run`` > ``agg.*`` / ``join.*`` >
    ``fabric.route`` > ``kernel.*``; every span is a CPU operation, not a
    user annotation (so it has no mirror on a device's timeline), and no
    operation of the query is one; every name opened is in ``NAMES``;
  * ``spans.py`` imports nothing of the port, so every layer, the kernels
    too, may open spans.
"""
import ast
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.db import Database

N = 1 << 12

# (depth, name) of each span a query opens, in the order opened
ROUTE = [(3, "fabric.route"), (4, "kernel.rank"), (4, "kernel.scatter")]
TREES = {
    "rdma_agg": [(0, "db.execute"), (1, "db.plan"), (1, "db.run"),
                 (2, "agg.preagg"), (3, "kernel.grouped_agg"),
                 (2, "agg.flush"), *ROUTE, (2, "agg.post")],
    "dist_agg": [(0, "db.execute"), (1, "db.plan"), (1, "db.run"),
                 (2, "agg.preagg"), (3, "kernel.grouped_agg"),
                 (2, "agg.flush")],
    "rrj": [(0, "db.execute"), (1, "db.plan"), (1, "db.run"),
            (2, "join.route"), *ROUTE, (2, "join.route"), *ROUTE,
            (2, "join.local")],
    "ghj": [(0, "db.execute"), (1, "db.plan"), (1, "db.run"),
            (2, "join.route"), *ROUTE, (2, "join.route"), *ROUTE,
            (2, "join.local")],
}


@pytest.fixture(scope="module")
def db():
    g = torch.Generator().manual_seed(7)
    d = Database(device="cpu")
    keys = torch.randint(0, 1 << 20, (N,), generator=g, dtype=torch.int32)
    ones = torch.ones((N,), dtype=torch.int32)
    d.load_table("T", keys, ones)
    rk = (torch.randperm(N, generator=g) + 1).to(torch.int32)
    d.load_table("R", rk, rk)
    d.load_table("S", rk[torch.randperm(N, generator=g)], ones)
    return d


def _plan(db, variant):
    if variant.endswith("_agg"):
        return db.scan("T").aggregate(groups=64)
    return db.scan("R").join(db.scan("S").filter(sel=1.0)).aggregate()


def _depth(e) -> int:
    d, p = 0, e.cpu_parent
    while p is not None:
        d, p = d + 1, p.cpu_parent
    return d


@pytest.mark.parametrize("name", spans.NAMES)
def test_span_without_a_profiler_is_the_shared_noop(name):
    assert not torch._C._autograd._profiler_enabled()
    assert spans.span(name) is spans.OFF


@pytest.mark.parametrize("variant", sorted(TREES))
def test_query_spans_nest_under_db_execute(db, variant):
    plan = _plan(db, variant)
    want = db.execute(plan, force_variant=variant).value
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = db.execute(plan, force_variant=variant).value
    assert torch.equal(got, want)
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    opened = [e for e in events if e.name in spans.NAMES]
    assert [(_depth(e), e.name) for e in opened] == TREES[variant]
    for e in opened[1:]:                 # each inside its parent's range
        p = e.cpu_parent
        assert p.name in spans.NAMES
        assert p.time_range.start <= e.time_range.start
        assert e.time_range.end <= p.time_range.end
    # spans are CPU operations: no user annotation, so no device mirror;
    # and the query path opens no range of its own any other way
    assert not [e.name for e in events if e.is_user_annotation]
    assert all(e.device_type == torch.autograd.DeviceType.CPU
               for e in opened)
    # every name the port opened is listed (the rest are aten operators)
    others = {e.name for e in events} - set(spans.NAMES)
    assert all(n.startswith("aten::") for n in others), others


def test_spans_module_is_a_leaf():
    tree = ast.parse(Path(spans.__file__).read_text())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
    imported |= {n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
    assert not {m for m in imported if m.split(".")[0] == "repro_torch"}
    assert len(set(spans.NAMES)) == len(spans.NAMES)
    assert all(n.count(".") == 1 and not n.startswith("nambench.")
               for n in spans.NAMES)
