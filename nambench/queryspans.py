"""The port's query spans in a traced slice.

The port opens its spans (``repro_torch.spans``) as host operations on
the profiler's clock, with no range on the device's timeline; each query
the facade runs is one ``db.execute`` and holds the others.  The readers
of the span metrics find them among the slice's host operations by name
and read nothing else, so a program that opens no span (one built before
them) reads nothing, and they return ``None``.
"""
from __future__ import annotations

from nambench.trace import Slice

EXECUTE = "db.execute"


def ranges(trace, name: str) -> list:
    """(start_us, end_us) of every span ``name`` in the slice, in order."""
    return sorted((s, e) for n, s, e in trace.host_ops if n == name)


def queries(trace) -> list:
    """The slice's ``db.execute`` spans; none without a trace."""
    return [] if trace is None else ranges(trace, EXECUTE)


def inside(outer, spans) -> list:
    """The spans that lie within ``outer``."""
    a, b = outer
    return [(s, e) for s, e in spans if a <= s and e <= b]


def per_query_ms(trace, name: str):
    """Milliseconds of the spans ``name`` held in a query, mean over the
    slice's queries; ``None`` where the slice has no query span."""
    qs = queries(trace)
    if not qs:
        return None
    mine = ranges(trace, name)
    return sum(e - s for q in qs for s, e in inside(q, mine)) / len(qs) / 1e3


def busy_us(device_ops, outer) -> float:
    """Microseconds of ``outer`` in which some device operation ran: the
    union of the operations, each clipped to ``outer``."""
    a, b = outer
    clipped = [(n, max(s, a), min(e, b)) for n, s, e in device_ops
               if s < b and e > a]
    return Slice([], 0.0, clipped, []).busy_s() * 1e6
