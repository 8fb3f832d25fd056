"""The paper's workload configurations (copied from ``repro.configs``)."""
from repro_torch.configs.paper_nam import OLAP, OLTP, OLAPWorkload, OLTPWorkload

__all__ = ["OLTP", "OLAP", "OLTPWorkload", "OLAPWorkload"]
