"""Network profiles: the paper's 1GbE -> IPoIB -> RDMA axis as data.

The paper's argument is an *axis*, not a point — every design verdict
(RSI vs 2PC, the four join variants, Dist-AGG vs RDMA-AGG, all-reduce vs
parameter server) flips somewhere between 1-Gigabit Ethernet and
InfiniBand EDR (§3, Figs. 1-4).  A :class:`NetworkProfile` is one point on
that axis as a value: the §3 microbenchmark constants a transport needs to
convert its counted messages/bytes into **modeled wall-clock**, and a
planner needs to price strategy alternatives.

The model of one posted verb batch carrying ``msgs`` messages and
``nbytes`` wire bytes:

    t_call = setup_s                                  (one doorbell/syscall)
           + msgs * max(cycles/(ghz*1e9), 1/msg_rate) (per-message pipeline:
                                                       host software stack
                                                       vs NIC verb rate —
                                                       the slower binds)
           + nbytes / bandwidth                       (the wire itself)

For the IPoEth/IPoIB software stacks the CPU term binds (the paper's Fig 3
point: IPoIB burns *more* cycles per message than 1GbE); for the one-sided
RDMA profiles the CPU term collapses to ~450 cycles and the NIC
message-rate cap is what is left for small messages (Fig 4).  For large
transfers the bandwidth term dominates on every profile, which is why the
modeled time still strictly decreases 1GbE -> EDR for byte-heavy work.

Shipped presets (see docs/netsim.md for the full provenance table):

  * ``ethernet_1g``  — 1GbE + TCP/IP: 0.125 GB/s, ~30us latency, 7544
                       cycles/msg (§3 Figs. 2-3).
  * ``ipoib_fdr``    — IP over InfiniBand FDR 4x: 3.5 GB/s measured
                       ceiling, ~20us latency, 13264 cycles/msg.
  * ``rdma_fdr4x``   — one-sided verbs on FDR 4x: 6.8 GB/s per port, ~1us,
                       450 cycles/msg, NIC small-message rate cap.
  * ``rdma_edr``     — the EDR endpoint of the paper's trend ("it
                       increases even further with the most recent EDR
                       standard"): ~12.1 GB/s, sub-us latency.

``from_counters()`` fits a profile from *measured* transport counters —
the generalization of the one-off ``calibrate=True`` path in the db
planner: feed it (stats, elapsed) samples from ``LocalTransport`` /
``MeshTransport`` runs and it least-squares the per-message and per-byte
constants.

This module is standard library only: a copy of ``repro.fabric.netsim``
kept in the port so that ``Transport(profile=)`` prices traffic without
importing the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Iterable, Optional, Tuple, Union

#: verbs whose counters are wire traffic (all of them — the fabric counts
#: nothing else); kept explicit so modeled_time() is robust to new keys.
WIRE_VERBS = ("read", "write", "cas", "fetch_add", "route", "exchange",
              "psum", "all_gather")


@dataclass(frozen=True)
class NetworkProfile:
    """One point on the 1GbE -> EDR axis (§3 microbenchmark constants).

    bandwidth:      large-message wire rate, bytes/s (§3 Fig 2 ceilings).
    setup_s:        per-posted-batch setup latency, seconds — one
                    doorbell/syscall per verb *call*, not per message
                    (~ the paper's small-message half round trip).
    msg_rate:       NIC verb-processing cap, messages/s (§3 Fig 4: what
                    bounds small messages once the host CPU is out of the
                    way).
    cycles_per_msg: host software-stack CPU cycles per message (§3 Fig 3;
                    the IPoEth/IPoIB overhead term — optional in the sense
                    that it is negligible for the one-sided profiles).
    cpu_ghz:        clock the cycle term is billed at (the paper's cluster).
    rdma:           whether the profile offers one-sided verbs — RDMA-only
                    strategies (RDMA GHJ/RRJ, RDMA-AGG, RSI) are infeasible
                    when False.
    """

    name: str
    bandwidth: float
    setup_s: float
    msg_rate: float
    cycles_per_msg: float
    cpu_ghz: float = 2.2
    rdma: bool = False

    # ------------------------------------------------------- derived -----

    @property
    def c_net(self) -> float:
        """Seconds per byte — the §5 cost-model wire constant."""
        return 1.0 / self.bandwidth

    @property
    def t_cpu_msg(self) -> float:
        """Host software-stack seconds per message (Fig 3 cycles)."""
        return self.cycles_per_msg / (self.cpu_ghz * 1e9)

    @property
    def t_nic_msg(self) -> float:
        """NIC verb-processing seconds per message (Fig 4 rate cap)."""
        return 1.0 / self.msg_rate

    @property
    def per_message_s(self) -> float:
        """The binding per-message stage: host CPU vs NIC rate."""
        return max(self.t_cpu_msg, self.t_nic_msg)

    # -------------------------------------------------------- model ------

    def t_bytes(self, nbytes: float) -> float:
        return nbytes * self.c_net

    def t_msgs(self, msgs: float) -> float:
        return msgs * self.per_message_s

    def t_call(self, msgs: float, nbytes: float, calls: int = 1) -> float:
        """Modeled wall-clock of `calls` posted batches totalling `msgs`
        messages and `nbytes` wire bytes."""
        return calls * self.setup_s + self.t_msgs(msgs) + self.t_bytes(
            nbytes)

    def bound(self, msgs: float, nbytes: float) -> str:
        """Which term dominates a (msgs, nbytes) transfer: 'cpu',
        'msg_rate', or 'bandwidth' (setup excluded — it is per call)."""
        per_msg = ("cpu" if self.t_cpu_msg >= self.t_nic_msg
                   else "msg_rate")
        return per_msg if self.t_msgs(msgs) >= self.t_bytes(nbytes) \
            else "bandwidth"

    def modeled_time(self, stats: Dict[str, dict]) -> float:
        """Total modeled wall-clock of a transport's counted traffic
        ({verb: {calls, msgs, bytes}} as ``Transport.stats()`` returns)."""
        total = 0.0
        for verb, s in stats.items():
            total += self.t_call(s.get("msgs", 0), s.get("bytes", 0),
                                 calls=s.get("calls", 0))
        return total

    def but(self, **overrides) -> "NetworkProfile":
        """A copy with fields replaced (what-if knob for experiments)."""
        return replace(self, **overrides)


# ------------------------------------------------------------ presets ----
# Calibrated to the paper's §3 microbenchmarks (Figs. 2-4): bandwidth
# ceilings and per-message CPU cycles are the measured numbers; setup
# latencies are the small-message half-RTTs; msg_rate is chosen so the
# per-message pipeline reproduces the Fig 4 small-message verb rates
# (for the RDMA profiles it, not the CPU term, is what binds).

ethernet_1g = NetworkProfile(
    name="ethernet_1g", bandwidth=0.125e9, setup_s=30e-6,
    msg_rate=1.0e6, cycles_per_msg=7544, rdma=False)

ipoib_fdr = NetworkProfile(
    name="ipoib_fdr", bandwidth=3.5e9, setup_s=20e-6,
    msg_rate=1.5e6, cycles_per_msg=13264, rdma=False)

rdma_fdr4x = NetworkProfile(
    name="rdma_fdr4x", bandwidth=6.8e9, setup_s=1e-6,
    msg_rate=4.0e6, cycles_per_msg=450, rdma=True)

rdma_edr = NetworkProfile(
    name="rdma_edr", bandwidth=12.1e9, setup_s=0.6e-6,
    msg_rate=6.0e6, cycles_per_msg=300, rdma=True)

#: the axis, slow -> fast (insertion order is load-bearing: sweeps and
#: ordering tests iterate it).
PROFILES: Dict[str, NetworkProfile] = {
    p.name: p for p in (ethernet_1g, ipoib_fdr, rdma_fdr4x, rdma_edr)}

#: legacy ``costmodel.C_NET`` keys -> preset names (the pre-profile repo
#: spelled the axis ipoeth/ipoib/rdma).
ALIASES: Dict[str, str] = {
    "ipoeth": "ethernet_1g",
    "ipoib": "ipoib_fdr",
    "rdma": "rdma_fdr4x",
}


def get_profile(net: Union[str, NetworkProfile]) -> NetworkProfile:
    """Resolve a preset name, legacy C_NET key, or profile instance."""
    if isinstance(net, NetworkProfile):
        return net
    key = ALIASES.get(net, net)
    if key not in PROFILES:
        raise ValueError(
            f"unknown net {net!r} — want one of {sorted(PROFILES)} "
            f"(or legacy {sorted(ALIASES)}), or a NetworkProfile")
    return PROFILES[key]


# -------------------------------------------------------- calibration ----

Sample = Union[Tuple[dict, float], Tuple[dict, float, float]]


def _totals(stats: Dict[str, dict]) -> Tuple[int, int, int]:
    """(calls, msgs, bytes) summed over a transport's per-verb counters."""
    calls = sum(s.get("calls", 0) for s in stats.values())
    msgs = sum(s.get("msgs", 0) for s in stats.values())
    nbytes = sum(s.get("bytes", 0) for s in stats.values())
    return calls, msgs, nbytes


def from_counters(samples: Union[Sample, Iterable[Sample]], *,
                  name: str = "calibrated", rdma: bool = True,
                  base: Optional[NetworkProfile] = None) -> NetworkProfile:
    """Fit a :class:`NetworkProfile` from measured transport counters.

    samples: one or more ``(stats, elapsed_s)`` or
    ``(stats, elapsed_s, compute_s)`` tuples — a transport's per-verb
    counters plus the wall-clock they were observed in (minus the run's
    modeled compute share, the same subtraction ``Planner.calibrate``
    performs so local `t_mem` passes are not billed to the wire).

    With two or more samples of different message/byte mix, the
    per-message and per-byte constants are separated by least squares on
    ``t = msgs * per_msg + bytes * c_net``.  With a single sample (or a
    degenerate mix) the whole wire share is attributed to bandwidth —
    exactly the planner's one-off ``calibrate=True`` behavior, which this
    function generalizes.

    The fitted profile encodes the per-message constant as a pure
    ``msg_rate`` cap (``cycles_per_msg=0``, ``setup_s=0``): measured
    counters cannot tell the host stack from the NIC apart, and the
    modeled time only depends on their max.  ``base`` (default
    ``rdma_fdr4x``) supplies the fields a fit cannot see (cpu_ghz, the
    rdma capability flag unless overridden by ``rdma=``).
    """
    if isinstance(samples, tuple) and samples and isinstance(
            samples[0], dict):
        samples = [samples]
    rows = []
    for sample in samples:
        stats, elapsed = sample[0], float(sample[1])
        compute = float(sample[2]) if len(sample) > 2 else 0.0
        _, msgs, nbytes = _totals(stats)
        wire_s = elapsed - compute
        if wire_s > 0 and (msgs > 0 or nbytes > 0):
            rows.append((float(msgs), float(nbytes), wire_s))
    if not rows:
        raise ValueError("from_counters needs at least one sample with "
                         "positive wire time and counted traffic")
    base = base or rdma_fdr4x
    # least squares for x = [per_msg, c_net] via 2x2 normal equations
    a11 = sum(m * m for m, _, _ in rows)
    a12 = sum(m * b for m, b, _ in rows)
    a22 = sum(b * b for _, b, _ in rows)
    b1 = sum(m * w for m, _, w in rows)
    b2 = sum(b * w for _, b, w in rows)
    det = a11 * a22 - a12 * a12
    per_msg = c_net = -1.0
    if len(rows) >= 2 and det > 1e-12 * max(a11 * a22, 1e-300):
        per_msg = (b1 * a22 - b2 * a12) / det
        c_net = (a11 * b2 - a12 * b1) / det
    if per_msg < 0 or c_net <= 0:
        # single sample / degenerate mix / unphysical fit: all-bandwidth
        per_msg = 0.0
        c_net = sum(w for _, _, w in rows) / max(
            sum(b for _, b, _ in rows), 1.0)
    return NetworkProfile(
        name=name, bandwidth=1.0 / c_net, setup_s=0.0,
        msg_rate=(1.0 / per_msg) if per_msg > 0 else 1e18,
        cycles_per_msg=0.0, cpu_ghz=base.cpu_ghz, rdma=rdma)
