"""repro_torch.analytics: advanced analytics on network-attached memory
(paper §6), a port of ``repro.analytics``.

The third workload pillar of the paper, on the same one-sided verb fabric
as OLTP and OLAP: a parameter server whose model state is a
:class:`~repro_torch.fabric.NamPool` region, pulled with one-sided READs
under a bounded-staleness epoch gate and updated by compressed gradient
pushes through the fabric router.
"""
from repro_torch.analytics.paramserver import (DEFAULT_SHARDS,
                                               ParameterServer, row_layout,
                                               sgd_apply)

__all__ = ["ParameterServer", "sgd_apply", "row_layout", "DEFAULT_SHARDS"]
