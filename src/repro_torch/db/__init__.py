"""repro_torch.db — the NAM-DB facade over the port's fabric (OLTP half).

  Database   tables + timestamp oracle over ONE fabric transport
  Table      an RSI version store bound to NamPool regions, with declared
             home-shard partitioning and a lock-word column
  Session    begin()/get/put/commit snapshot transactions; waves of
             sessions commit as one routed fabric round trip ("rsi" or
             "2pc")
"""
from repro_torch.db.database import Database, backoff_slots
from repro_torch.db.partition import assign_workers, home_shard, \
    local_fraction
from repro_torch.db.session import ISOLATION_LEVELS, Session
from repro_torch.db.table import Table, TableSchema

__all__ = [
    "Database", "Session", "ISOLATION_LEVELS", "Table", "TableSchema",
    "assign_workers", "home_shard", "local_fraction", "backoff_slots",
]
