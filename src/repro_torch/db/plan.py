"""Logical query plans: ``scan -> filter(bloom) -> join -> aggregate``.

A copy of ``repro.db.plan`` (plain dataclasses).

Plans are small immutable trees built with a fluent API::

    q = db.scan("R").join(db.scan("S").filter(sel=0.5)).aggregate()
    g = db.scan("T").aggregate(groups=4096)

A plan says *what* (which relations, the declared probe selectivity, the
group count); the network-aware planner (``repro_torch.db.planner``) decides
*how* — which shuffle strategy (GHJ / GHJ+Bloom / RDMA-GHJ / RRJ) or which
aggregation scheme (Dist-AGG / RDMA-AGG) — from the §5.1/§5.3 cost models.
``filter(sel=...)`` is the semi-join reduction's declared selectivity: it
feeds the Bloom decision rather than forcing it, exactly the paper's point
that the reduction only sometimes pays off (§5.1.3).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class Plan:
    """One logical operator node.  op in {scan, filter, join, aggregate}."""
    op: str
    children: Tuple["Plan", ...] = ()
    table: Optional[str] = None       # scan
    sel: float = 1.0                  # filter: estimated join selectivity
    groups: Optional[int] = None      # aggregate: distinct groups
                                      #   (None = scalar join aggregate)

    # ------------------------------------------------------ fluent build --

    def filter(self, *, sel: float) -> "Plan":
        """Declare the estimated fraction of this side that survives the
        semi-join (0 < sel <= 1). The planner may realize it as a Bloom
        filter (GHJ+Bloom) when the cost model says the reduction pays."""
        if not 0.0 < sel <= 1.0:
            raise ValueError(f"sel={sel} outside (0, 1]")
        return Plan("filter", (self,), sel=sel)

    def join(self, other: "Plan") -> "Plan":
        """Key equi-join; self is the (unique-key) build side R."""
        return Plan("join", (self, other))

    def aggregate(self, groups: Optional[int] = None) -> "Plan":
        """groups=None on a join: the scalar join aggregate (sum of matched
        value products). groups=G on a scan/filter: grouped sum by key
        hash, the §5.3 workload."""
        if groups is not None and groups < 1:
            raise ValueError(f"groups={groups} < 1")
        if groups is not None and self.op == "join":
            raise ValueError("a join aggregate is scalar; groups= applies "
                             "to scan/filter aggregates only")
        return Plan("aggregate", (self,), groups=groups)

    # ---------------------------------------------------------- analysis --

    def scan_table(self) -> str:
        """The single base table under a scan/filter chain."""
        node = self
        while node.op == "filter":
            node = node.children[0]
        if node.op != "scan":
            raise ValueError(f"expected scan under {self.op}, got {node.op}")
        return node.table

    def selectivity(self) -> float:
        """Product of declared selectivities along a scan/filter chain."""
        node, sel = self, 1.0
        while node.op == "filter":
            sel *= node.sel
            node = node.children[0]
        return sel

    def kind(self) -> str:
        """Executable shape: 'join_agg' | 'group_agg' | 'scan'."""
        if self.op == "aggregate":
            child = self.children[0]
            if child.op == "join":
                return "join_agg"
            return "group_agg"
        if self.op == "join":
            raise ValueError("bare join has no output shape; call "
                             ".aggregate() to reduce it")
        return "scan"

    def describe(self) -> str:
        if self.op == "scan":
            return f"scan({self.table})"
        if self.op == "filter":
            return f"{self.children[0].describe()}.filter(sel={self.sel})"
        if self.op == "join":
            return (f"{self.children[0].describe()}"
                    f".join({self.children[1].describe()})")
        g = "" if self.groups is None else f"groups={self.groups}"
        return f"{self.children[0].describe()}.aggregate({g})"
