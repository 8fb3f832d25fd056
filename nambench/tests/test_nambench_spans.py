"""The readers of the port's query spans, on hand-built traced slices:

  * each of the five span metrics reads its exact value from known spans
    and device operations: a device operation that overhangs a
    ``db.execute`` counts only inside it, and one in the gap between two
    queries counts for nothing;
  * each returns ``None`` without a trace, and on a slice of a program
    that opens no span (only the benchmark's own ``nambench.execute``);
  * every span name a reader looks for is one the port opens
    (``repro_torch.spans.NAMES``).
"""
import ast
import re
from types import SimpleNamespace

import pytest

from nambench.spec import PACKAGE, Spec
from nambench.trace import Slice
from repro_torch.spans import NAMES

READERS = ("facade_self_ms.query", "plan_ms.query", "issue_ms.query",
           "sync_wait_ms.query", "query_idle_pct.query")

# two queries of 100 us each, 100 us apart; times in us as the profiler's
HOST = [
    ("nambench.execute", -1.0, 101.0),
    ("db.execute", 0.0, 100.0),
    ("db.plan", 2.0, 6.0),
    ("db.run", 10.0, 60.0),
    ("aten::add", 12.0, 14.0),
    ("db.sync", 60.0, 90.0),
    ("nambench.execute", 199.0, 301.0),
    ("db.execute", 200.0, 300.0),
    ("db.plan", 201.0, 204.0),
    ("db.run", 210.0, 250.0),
    ("db.sync", 250.0, 280.0),
]
DEVICE = [
    ("a", 20.0, 50.0),      # query 1
    ("b", 40.0, 70.0),      # overlaps a: their union is 50 us
    ("c", 95.0, 130.0),     # overhangs query 1's end: 5 us count
    ("d", 150.0, 190.0),    # between the queries: counts for nothing
    ("e", 190.0, 230.0),    # overhangs query 2's start: 30 us count
    ("f", 260.0, 270.0),    # query 2
]
# per query: plan 4 and 3 us, run 50 and 40, sync 30 and 30, execute 100
# and 100; busy 55 of query 1's 100 us and 40 of query 2's
WANT = {
    "facade_self_ms.query": (100 - 45 - 30) / 1e3,
    "plan_ms.query": 3.5 / 1e3,
    "issue_ms.query": 45 / 1e3,
    "sync_wait_ms.query": 30 / 1e3,
    "query_idle_pct.query": 100.0 * (1 - 95 / 200),
}


def _ctx(host, device):
    return SimpleNamespace(trace=Slice([], 1.0, device, host))


@pytest.mark.parametrize("metric", READERS)
def test_reader_on_known_spans(metric):
    got = Spec().reader(metric)(_ctx(HOST, DEVICE))
    assert got == pytest.approx(WANT[metric], rel=1e-12)


@pytest.mark.parametrize("metric", READERS)
def test_reader_reads_nothing_without_spans(metric):
    read = Spec().reader(metric)
    assert read(SimpleNamespace(trace=None)) is None
    parent = [o for o in HOST if not o[0].startswith("db.")]
    assert read(_ctx(parent, DEVICE)) is None


def test_readers_look_for_spans_the_port_opens():
    span_like = re.compile(r"^[a-z]+\.[a-z_]+$")
    found = set()
    for path in [PACKAGE / "queryspans.py"] + [
            PACKAGE / "metrics" / f"{m}.py" for m in READERS]:
        tree = ast.parse(path.read_text())
        found |= {n.value for n in ast.walk(tree)
                  if isinstance(n, ast.Constant) and isinstance(n.value, str)
                  and span_like.match(n.value)}
    assert {"db.execute", "db.plan", "db.run", "db.sync"} <= found
    assert found <= set(NAMES)


def test_span_metrics_are_listed_for_both_query_cells():
    spec = Spec()
    listed = {m.name: m for m in spec.per_layer}
    for name in READERS:
        assert listed[name].moves == "query_ms"
        assert listed[name].workloads == ("olap-join-mix",
                                          "olap-agg-large-g")
