"""Traditional 2PC/SI baseline (paper §4.1, Fig 5a), for comparison.

The data-plane outcome equals RSI's under the same priority order (2PC
prepare = validate+lock at the RM; commit = install+unlock), so the
commit reuses RSI's arbitration.  What differs is the message economics:
``message_counts`` is the paper's §4.1.3 model of the TM-coordinated
protocol.
"""
from __future__ import annotations

from repro_torch.core import rsi


def commit(store, txns, priority=None, transport=None, chunks: int = 1,
           region_ns: str = ""):
    """2PC/SI commit of a txn batch via a TM: same schedule as RSI."""
    return rsi.commit(store, txns, transport=transport, priority=priority,
                      chunks=chunks, region_ns=region_ns)


def message_counts(n_rm: int) -> dict:
    """Per-transaction messages in the traditional protocol (§4.1.3):
    m_r = 2 + 4n, m_s = 3 + 4n over TM+RMs; plus the client pair."""
    return {"recv": 2 + 4 * n_rm, "send": 3 + 4 * n_rm,
            "total": 5 + 8 * n_rm, "delays_visible": 6}


def rsi_message_counts(n_writes: int = 3) -> dict:
    """RSI (§4.2): CID fetch is local (pre-assigned bitvector slots); one CAS
    round trip per record (parallel => 1 delay), one WRITE per record, one
    unsignaled bitvector update. Server-side CPU messages: zero."""
    return {"cas": n_writes, "write": n_writes, "unsignaled": 1,
            "round_trips": 3, "server_cpu_msgs": 0}
