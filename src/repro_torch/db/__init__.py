"""repro_torch.db — the NAM-DB facade over the port's fabric.

  Database   tables + timestamp oracle + planner over ONE fabric transport
  Table      an RSI version store + key column bound to NamPool regions,
             with declared home-shard partitioning and a lock-word column
  Session    begin()/get/put/commit snapshot transactions; waves of
             sessions commit as one routed fabric round trip ("rsi" or
             "2pc")
  Plan       logical scan -> filter(bloom) -> join -> aggregate trees
  Planner    §5.1/§5.3 network cost models pick GHJ / GHJ+Bloom /
             RDMA-GHJ / RRJ and Dist-AGG / RDMA-AGG; explain() returns
             every costed alternative
"""
from repro_torch.db.database import (Database, Explain, QueryResult,
                                     backoff_slots)
from repro_torch.db.partition import assign_workers, home_shard, \
    local_fraction
from repro_torch.db.plan import Plan
from repro_torch.db.planner import (AGG_VARIANTS, JOIN_VARIANTS,
                                    Alternative, Planner)
from repro_torch.db.session import ISOLATION_LEVELS, Session
from repro_torch.db.table import Table, TableSchema

__all__ = [
    "Database", "Explain", "QueryResult", "Plan",
    "Planner", "Alternative", "JOIN_VARIANTS", "AGG_VARIANTS",
    "Session", "ISOLATION_LEVELS", "Table", "TableSchema",
    "assign_workers", "home_shard", "local_fraction", "backoff_slots",
]
