"""Network-aware cost models, in the port.

A copy of ``repro.core.costmodel`` that takes its network constants from
the port's :mod:`repro_torch.fabric.netsim`:

1. The paper's OLAP join cost model (§5.1) — reproduces Fig 7 — and the
   §5.3 aggregation models the planner prices.
2. The paper's OLTP message model (§4.1.3) — feeds Fig 6.
3. The §6 parameter-server communication model.

The JAX package's TPU roofline block (``TpuSpec``, ``roofline_terms``,
``model_flops*``) is left out: an H100 counterpart comes with the port's
sharding and launch code.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.fabric import netsim

# ---------------------------------------------------------------- paper ---

C_MEM = 1e-9                       # s/byte — paper's main-memory constant
# idealized s/byte at 2KB messages (paper §3 microbenchmarks) — the values
# live in the shipped NetworkProfile presets (repro.fabric.netsim); these
# legacy-keyed views exist so the §4 OLTP model and older call sites keep
# their ipoeth/ipoib/rdma spelling.
C_NET = {k: netsim.get_profile(k).c_net for k in ("ipoeth", "ipoib",
                                                  "rdma")}
# per-message CPU cycles (Fig 3, small messages)
CYCLES_PER_MSG = {k: int(netsim.get_profile(k).cycles_per_msg)
                  for k in ("ipoeth", "ipoib", "rdma")}
BLOOM_ERROR = 0.10


def _c_net(net) -> float:
    """Resolve net to s/byte: a NetworkProfile, a preset/legacy name, or a
    raw float (e.g. calibrated from measured fabric byte counters)."""
    if isinstance(net, netsim.NetworkProfile):
        return net.c_net
    if isinstance(net, str):
        return netsim.get_profile(net).c_net
    return float(net)


def t_mem(nbytes):
    return nbytes * C_MEM


def t_net(nbytes, net):
    """net: a NetworkProfile, a profile preset / legacy C_NET key, or a
    float s/byte (e.g. calibrated from the fabric transport's measured
    byte counters by ``repro.db.planner`` / ``netsim.from_counters``)."""
    return nbytes * _c_net(net)


def t_part(nbytes, net: str):
    """Repartition cost (§5.1.1): read + wire + materialize."""
    return 2 * t_mem(nbytes) + t_net(nbytes, net)


def t_join_radix(nbytes_r, nbytes_s):
    """Local radix join: two memory-bound passes over both sides."""
    return 2 * (t_mem(nbytes_r) + t_mem(nbytes_s))


def t_ghj(nr, ns, net: str):
    """|R|,|S| in bytes. T = (wR+wS)(4 c_mem + c_net)."""
    return t_part(nr, net) + t_part(ns, net) + t_join_radix(nr, ns)


def t_ghj_bloom(nr, ns, net: str, sel: float):
    """Semi-join reduction (§5.1.2); sel = join selectivity, bloom error
    inflates the shipped fraction."""
    eff = min(sel + BLOOM_ERROR * (1 - sel), 1.0)
    create = t_mem(nr) + t_mem(ns)          # build both bloom filters
    part = t_part(eff * nr, net) + t_part(eff * ns, net)
    join = t_join_radix(eff * nr, eff * ns)
    return create + part + join


def t_rdma_ghj(nr, ns, net: str = "rdma"):
    """RDMA GHJ (§5.2): receiver writes happen in the background
    (selective signaling) => partition cost is one memory pass per side —
    as long as the wire keeps up.  §5.2's derivation assumes
    c_net ~ c_mem; when the *effective* per-byte cost rises above that
    (a contended fabric — e.g. ``sim.contended_profile`` under
    ``Planner(load=...)``) the hidden wire becomes the bottleneck and the
    overlapped partition pass degrades to the wire rate."""
    part = max(t_mem(nr) + t_mem(ns), t_net(nr + ns, net))
    return part + t_join_radix(nr, ns)


def t_rrj(nr, ns, net: str = "rdma"):
    """RRJ (§5.2): network partition fused with the radix pass;
    T = 2 c_mem (wR+wS) (assuming c_net ~ c_mem and one pass).  The fused
    pass streams every tuple over the wire once, so — like t_rdma_ghj —
    it runs at max(memory, wire) rate: free only while the network keeps
    up, degrading under contention (which is exactly what makes the
    fig10 load crossover possible: RRJ ships full relations, the bloom
    variant ships the reduced fraction)."""
    return max(2 * (t_mem(nr) + t_mem(ns)), t_net(nr + ns, net))


AGG_GROUP_BYTES = 16          # group row on the wire: u32 key + u64 + pad
CPU_GHZ = 2.2                 # per-message CPU cost base (Fig 3 cluster)


def t_msgs(n_msgs, net):
    """Per-message time: the profile's binding per-message stage — host
    CPU cycles (Fig 3) vs the NIC message-rate cap (Fig 4), whichever is
    slower.  A calibrated float net (s/byte) carries no message constant;
    bill it at the RDMA FDR rate."""
    p = netsim.get_profile(net if isinstance(
        net, (str, netsim.NetworkProfile)) else "rdma")
    return n_msgs * p.per_message_s


def t_dist_agg(nbytes, groups, net, nodes: int = 4,
               group_bytes: int = AGG_GROUP_BYTES):
    """Dist-AGG (§5.3): local aggregation pass over the data, then a global
    union that ships and re-aggregates nodes x groups rows on every node —
    the term that makes the classic scheme degrade with distinct count.
    One union message per peer."""
    union = nodes * groups * group_bytes
    return (t_mem(nbytes) + t_part(union, net) + t_mem(union)
            + t_msgs(nodes, net))


def t_rdma_agg(nbytes, groups, net="rdma", nodes: int = 4,
               group_bytes: int = AGG_GROUP_BYTES, flush_chunks: int = 4):
    """RDMA-AGG (§5.3): cache-sized pre-aggregation (one pass over the
    data); partition-table overflow is flushed in the background (selective
    signaling hides the wire, leaving the materialize pass over the flushed
    tables), and each owner post-aggregates only its groups/nodes slice.
    The flush posts chunks x nodes table messages — the fixed overhead that
    lets the classic scheme win at tiny distinct counts (Fig 8b's left
    edge)."""
    flush = flush_chunks * groups * group_bytes
    return (t_mem(nbytes) + t_mem(flush) + t_mem(groups * group_bytes
                                                 / nodes)
            + t_msgs(flush_chunks * nodes, net))


# -------------------------------------------------------- analytics §6 ----

def t_allreduce(nbytes, workers: int, net="rdma"):
    """Synchronous ring all-reduce of an `nbytes` gradient across `workers`:
    each worker wires 2 (W-1)/W of the gradient (reduce-scatter +
    all-gather) in 2 (W-1) messages — the §6 baseline every worker must
    finish before any can step (the straggler pays twice: once in the
    barrier, once here)."""
    if workers <= 1:
        return 0.0
    wire = 2 * (workers - 1) / workers * nbytes
    return t_net(wire, net) + t_msgs(2 * (workers - 1), net)


def t_ps_pull(nbytes, shards: int, net="rdma", staleness: int = 0,
              workers: int = 1):
    """Expected per-step pull cost of the bounded-stale parameter server:
    one 1-word READ of the FETCH_ADD epoch counter always, plus a full
    `nbytes` shard READ only when the worker's cache fell more than
    `staleness` epochs behind.  With W workers pushing round-robin a cache
    ages ~W epochs per own step, so the refresh probability is
    min(1, W / (k+1)) — k=0 re-READs every step, k >= W amortizes."""
    p_refresh = min(1.0, workers / (staleness + 1))
    return (t_msgs(1, net)
            + p_refresh * (t_net(nbytes, net) + t_msgs(shards, net)))


def t_ps_push(nbytes, shards: int, net="rdma", compress_ratio: float = 1.0):
    """Per-step push cost: the routed gradient pays `compress_ratio` x
    `nbytes` on the wire (int8 codes + per-block scales ~ 0.27 for
    block=256) in one fixed-buffer route per shard, plus the 1-word
    FETCH_ADD bumping the epoch."""
    return (t_net(compress_ratio * nbytes, net) + t_msgs(shards + 1, net))


def t_ps_step(nbytes, shards: int, net="rdma", staleness: int = 0,
              workers: int = 1, compress_ratio: float = 1.0):
    """One worker-step of §6 parameter-server communication (pull + push).
    Compare against :func:`t_allreduce` at the same `nbytes`: the PS trades
    the barrier for bounded staleness and compressed push bytes —
    `benchmarks/fig9_ml.py` reports this prediction next to the fabric
    transport's measured counters."""
    return (t_ps_pull(nbytes, shards, net, staleness=staleness,
                      workers=workers)
            + t_ps_push(nbytes, shards, net, compress_ratio=compress_ratio))


# ------------------------------------------------------------- OLTP §4 ----

@dataclass(frozen=True)
class OltpModel:
    cores_per_node: int = 8
    ghz: float = 2.2
    record_bytes: int = 1024
    records_per_txn: int = 3

    def trx_upper_bound_cpu(self, n_servers: int, net,
                            cycles_per_msg: float = None) -> float:
        """§4.1.3: trx_u = (c * cycles_c * (n+1)) / ((5+8n) * cycles_m).
        net: a profile preset / legacy key or a NetworkProfile."""
        cm = cycles_per_msg or netsim.get_profile(net).cycles_per_msg
        cyc = self.cores_per_node * self.ghz * 1e9
        msgs = 5 + 8 * n_servers
        return cyc * (n_servers + 1) / (msgs * cm)

    def trx_upper_bound_bw(self, net, ports: int = 1) -> float:
        """Bandwidth cap at the bottleneck machine (paper §4.3): each txn
        reads AND writes records_per_txn * record_bytes, so the dual-port
        aggregate divides by 2x the per-txn bytes."""
        bw = 1 / _c_net(net) * ports
        return bw / (2 * self.records_per_txn * self.record_bytes)

    def rsi_bound(self, n_servers: int = 3, ports: int = 2) -> float:
        """RSI is RNIC/bandwidth-bound (server CPUs idle): the paper's
        ~2.4M txn/s cap for 1KB x 3 records on dual-port FDR."""
        return self.trx_upper_bound_bw("rdma", ports)
