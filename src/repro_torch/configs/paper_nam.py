"""The paper's own workload configs (§4.3 OLTP, §5.4 OLAP).

These parameterize the NAM-core benchmarks, not an LM architecture.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class OLTPWorkload:
    """TPC-W-checkout-like write-heavy workload (§4.3)."""
    num_products: int = 1_000_000     # base records (1 KB each in the paper)
    record_bytes: int = 1024
    reads_per_txn: int = 3            # read 3 products
    updates_per_txn: int = 3          # update 3 stocks
    inserts_per_txn: int = 4          # 1 order + 3 orderlines
    num_storage_nodes: int = 3
    num_client_nodes: int = 4
    version_slots: int = 1            # paper's current impl: n=1


@dataclass(frozen=True)
class OLAPWorkload:
    """Join/aggregation workload (§5.4)."""
    tuples_per_node: int = 128_000_000   # |R| = |S| per node in the paper
    tuple_bytes: int = 8                 # w_r = w_s = 8 B
    num_nodes: int = 4
    threads_per_node: int = 10
    bloom_selectivities: tuple = (0.25, 0.5, 0.75, 1.0)
    bloom_error: float = 0.10
    distinct_groups_sweep: tuple = (1, 64, 4096, 262144, 16_777_216, 67_108_864)


OLTP = OLTPWorkload()
OLAP = OLAPWorkload()
