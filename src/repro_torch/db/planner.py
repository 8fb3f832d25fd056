"""The network-aware planner: §5.1/§5.3 cost models pick the strategy.

The port of ``repro.db.planner``.  :class:`Planner` prices every
alternative with the formulas in :mod:`repro_torch.core.costmodel` against
one :class:`~repro_torch.fabric.NetworkProfile` (a point on the paper's
1GbE -> EDR axis) and returns the full costed list, argmin first.
Sweeping planners across profiles reproduces the paper's crossovers: the
argmin changes as the profile moves along the axis.

Calibration: ``t_net`` accepts a raw s/byte constant, so a planner can
refine the preset profile with the measured economics of prior runs —
:meth:`Planner.calibrate` takes the transport's byte counters and the
observed wall clock, and later plans are priced with the observed wire
rate.

Planning under load (``load > 0``) derates the wire with the contention
simulator: :func:`repro_torch.fabric.sim.contended_profile` measures the
bandwidth a probe transfer gets while ``load`` tenant streams share its
ingress, and the plans are priced on that profile.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional

from repro_torch.core import costmodel
from repro_torch.core.shuffle import JOIN_VARIANTS
from repro_torch.fabric import netsim, sim

AGG_VARIANTS = ("dist_agg", "rdma_agg")


@dataclass(frozen=True)
class Alternative:
    """One costed strategy: feasible=False means the variant needs one-sided
    verbs the modeled network does not offer (RDMA variants off-RDMA)."""
    name: str
    cost_s: float
    feasible: bool = True
    chosen: bool = False

    def pretty(self) -> str:
        mark = "*" if self.chosen else (" " if self.feasible else "x")
        return f"{mark} {self.name:<10} {self.cost_s * 1e3:10.3f} ms"


def _choose(alts: List[Alternative]) -> List[Alternative]:
    """Mark the cheapest feasible alternative chosen; argmin-first order."""
    best = min((a for a in alts if a.feasible), key=lambda a: a.cost_s)
    alts = [replace(a, chosen=(a is best)) for a in alts]
    return sorted(alts, key=lambda a: (not a.feasible, a.cost_s))


class Planner:
    """Prices join/aggregation strategies for one modeled network.

    net:    a :class:`~repro.fabric.NetworkProfile`, a preset name
            ("ethernet_1g" | "ipoib_fdr" | "rdma_fdr4x" | "rdma_edr"), or
            a legacy C_NET key ("ipoeth" | "ipoib" | "rdma") — what the
            fabric transport is modeled as.
    nodes:  cluster size the cost model assumes (the §5.4 deployment); the
            Database passes the transport's shard count, or the paper's
            4-node cluster for the single-shard degenerate case.
    load:   concurrent tenant streams sharing the fabric (0 = isolated,
            the classic analytic argmin).  A non-zero load derates the
            wire constant through ``sim.contended_profile``, so the plan
            chosen under contention can differ from the isolated argmin
            (the fig10 crossover: rrj ships full relations and loses its
            fused-pass advantage as the wire degrades, while ghj_bloom
            ships only the reduced fraction).
    """

    def __init__(self, net="rdma", nodes: int = 4, load: int = 0):
        self.profile = netsim.get_profile(net)    # ValueError on unknown
        self.net = net if isinstance(net, str) else self.profile.name
        self.nodes = max(int(nodes), 1)
        self.load = max(int(load), 0)
        self._contended: Optional[netsim.NetworkProfile] = None
        self._c_net_measured: Optional[float] = None

    # ------------------------------------------------------- calibration --

    def calibrate(self, stats: dict, elapsed_s: float,
                  compute_s: float = 0.0):
        """Refine the wire constant from measured fabric counters: the
        bytes the router/exchange actually moved in `elapsed_s` seconds of
        a prior run.  `compute_s` is the run's modeled non-wire time (the
        variant's cost with a free wire, see :meth:`compute_share`) —
        subtracted first so local compute passes, which the §5.1 formulas
        already price via `t_mem`, are not double-billed to the wire.
        Leaves calibration unchanged (returns None) when the wire share
        comes out non-positive.  Returns the s/byte installed."""
        wire = sum(v["bytes"] for k, v in stats.items()
                   if k in ("route", "exchange", "all_gather", "psum"))
        wire_s = elapsed_s - compute_s
        if wire > 0 and wire_s > 0:
            self._c_net_measured = wire_s / wire
            return self._c_net_measured
        return None

    def compute_share(self, kind: str, variant: str, inputs: dict) -> float:
        """A variant's modeled cost with a FREE wire (c_net = 0): the
        compute/memory share that calibrate() subtracts from wall clock.
        kind/inputs are what Database._analyze produces."""
        free = 0.0          # s/byte: t_net prices to zero
        if kind == "join_agg":
            nr, ns = inputs["nr_bytes"], inputs["ns_bytes"]
            return {
                "ghj": costmodel.t_ghj(nr, ns, free),
                "ghj_bloom": costmodel.t_ghj_bloom(nr, ns, free,
                                                   inputs["sel"]),
                "rdma_ghj": costmodel.t_rdma_ghj(nr, ns, free),
                "rrj": costmodel.t_rrj(nr, ns, free),
            }[variant]
        nb, groups = inputs["nbytes"], inputs["groups"]
        return {
            "dist_agg": costmodel.t_dist_agg(nb, groups, free,
                                             nodes=self.nodes),
            "rdma_agg": costmodel.t_rdma_agg(nb, groups, free,
                                             nodes=self.nodes),
        }[variant]

    @property
    def loaded_profile(self) -> netsim.NetworkProfile:
        """The profile as the simulator measures it under ``self.load``
        concurrent tenant streams (the profile itself at load 0); the
        contention simulation runs once per planner."""
        if self.load == 0:
            return self.profile
        if self._contended is None:
            self._contended = sim.contended_profile(self.profile, self.load)
        return self._contended

    @property
    def effective_net(self):
        """What t_net is priced with: the measured s/byte if calibrated,
        else the (load-derated) network profile.  A calibrated constant is
        scaled by the same simulated degradation the profile sees."""
        if self._c_net_measured is not None:
            if self.load == 0:
                return self._c_net_measured
            scale = self.loaded_profile.c_net / self.profile.c_net
            return self._c_net_measured * scale
        return self.loaded_profile

    # -------------------------------------------------------------- joins --

    def join_alternatives(self, nr_bytes: int, ns_bytes: int,
                          sel: float = 1.0) -> List[Alternative]:
        """All four §5.1/§5.2 variants, costed; argmin-first.  The RDMA
        variants are only feasible when the modeled network offers
        one-sided verbs (profile.rdma)."""
        net = self.effective_net
        rdma_ok = self.profile.rdma
        alts = [
            Alternative("ghj", costmodel.t_ghj(nr_bytes, ns_bytes, net)),
            Alternative("ghj_bloom",
                        costmodel.t_ghj_bloom(nr_bytes, ns_bytes, net, sel)),
            Alternative("rdma_ghj",
                        costmodel.t_rdma_ghj(nr_bytes, ns_bytes, net),
                        feasible=rdma_ok),
            Alternative("rrj", costmodel.t_rrj(nr_bytes, ns_bytes, net),
                        feasible=rdma_ok),
        ]
        return _choose(alts)

    # -------------------------------------------------------- aggregation --

    def agg_alternatives(self, nbytes: int,
                         groups: int) -> List[Alternative]:
        """Dist-AGG vs RDMA-AGG (§5.3), costed; argmin-first."""
        net = self.effective_net
        alts = [
            Alternative("dist_agg",
                        costmodel.t_dist_agg(nbytes, groups, net,
                                             nodes=self.nodes)),
            Alternative("rdma_agg",
                        costmodel.t_rdma_agg(nbytes, groups, net,
                                             nodes=self.nodes),
                        feasible=self.profile.rdma),
        ]
        return _choose(alts)

    # ------------------------------------------------------------ summary --

    @staticmethod
    def chosen(alts: List[Alternative]) -> str:
        return next(a.name for a in alts if a.chosen)
