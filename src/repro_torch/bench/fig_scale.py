"""fig_scale in the port: the million-transaction curve, throughput against
worker count under Zipf contention, with group commit, abort/retry
economics and the locality toggle (*The End of a Myth*, on the verb
fabric).

The counterpart of ``benchmarks/fig_scale.py``, whose constants are the
defaults here.  Three panels, each asserted inline as in the JAX
benchmark:

(a) **Abort/retry economics** (real commits): for each worker count,
    every worker's transactions commit as one coalesced
    ``Database.commit_grouped`` wave with ``max_retries`` bounded retry
    and deterministic backoff.  Under the shared Zipf streams of
    :mod:`repro_torch.bench.workloads` the hottest rank is the same
    record for every worker, so skew turns into CAS losses.  Asserted:
    the Zipf(1.2) abort rate exceeds uniform's at every worker count.

(b) **Throughput vs workers**: each economics run is synthesized into a
    simulator trace (:func:`commit_trace`: worker ``w`` an agent pinned
    to node ``w`` of a ``workers``-shard fabric, its prepare CASes and
    install WRITEs pointed at each record's home shard, its grant share
    riding one exchange round, each retry round behind a backoff
    ``compute`` event) and replayed on the 1GbE -> EDR axis.  Asserted:
    uniform throughput grows >= 3x from 4 to 32 workers on every profile,
    and Zipf(1.2)'s growth stays below it.

(c) **Locality**: the home-affine Zipf(1.2) workload priced under both
    placements of ``assign_workers``: co-located (hot verbs loop back)
    against the derangement (every hot verb one shard away).  Asserted:
    co-location wins on every RDMA profile.

Sizes are keywords (records, payload words, transactions a worker), so
the same panels run at the JAX benchmark's 4096 one-word records and at
the paper's §4.3 store (1 000 000 records of 1 KB); there panels (b) and
(c) take ``row_bytes=row_bytes(payload_words)``, so an install WRITE
carries the real row (the JAX benchmark prices every row at 36 B).  Every transaction
writes ``1 + its global index`` into every word of its rows (the JAX
benchmark writes ones; the economics do not depend on the payload), so a
committed write can be read back.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from repro_torch._bits import resolve_device
from repro_torch.bench import checkout, timing, workloads
from repro_torch.db import Database, assign_workers, home_shard, \
    local_fraction
from repro_torch.db.database import BACKOFF_SLOT_S, backoff_slots
from repro_torch.fabric import netsim, sim

DEFAULT_PROFILES = ("ethernet_1g", "ipoib_fdr", "rdma_fdr4x", "rdma_edr")
WORKERS = (1, 2, 4, 8, 16, 32, 64)
SKEWS = {"uniform": 0.0, "zipf09": 0.9, "zipf12": 1.2}
RECORDS = 4096
TXNS_PER_WORKER = 8
WRITES_PER_TXN = 2
MAX_RETRIES = 3
SEED = 7
AGENT_WINDOW = 2        # outstanding grouped waves per worker agent
CAS_BYTES = 8           # prepare: compare+swap word on the wire
ROW_BYTES = 36          # install: 8 payload words + the version word
                        # (the JAX benchmark's; row_bytes() at other sizes)
READ_BYTES = 8          # retry refresh: current lock|CID word
LOCALITY_WORKERS = 32


# ------------------------------------------------- panel (a): economics --


def economics_db(*, records: int = RECORDS, payload_words: int = 1,
                 device=None, impl=None) -> Database:
    """A fresh counted database with the ``acct`` table seeded: record r
    holds r in every word."""
    d = Database(device=device, impl=impl)
    t = d.create_table("acct", records, payload_words=payload_words,
                       num_timestamps=8 * records)
    t.seed(np.arange(records), np.arange(records).reshape(-1, 1))
    return d


def groups_of(d: Database, sets) -> list:
    """One session group a worker, one session a transaction: each puts
    ``1 + its global index`` into every word of its rows, blind (read cid
    1, the seed's)."""
    m = d.table("acct").schema.payload_words
    groups, k = [], 0
    for wsets in sets:
        g = []
        for recs in wsets:
            k += 1
            s = d.session().begin()
            s.put("acct", recs, np.full((len(recs), m), k, np.uint32),
                  read_cids=np.ones(len(recs), np.uint32))
            g.append(s)
        groups.append(g)
    return groups


def run_economics(workers: int, skew: float, *, shared: bool = True,
                  records: int = RECORDS, payload_words: int = 1,
                  txns_per_worker: int = TXNS_PER_WORKER, device=None,
                  impl=None, keep: bool = False, around=None, sets=None):
    """Real grouped commit of one wave of ``workers`` session groups on a
    fresh counted Database.  Returns (txn economics, per-txn write sets,
    per-txn attempts, per-txn ids); ``keep=True`` adds a dict with the
    database, the groups, the committed masks and the host seconds of the
    ``commit_grouped`` call (its retry waves included).  ``around()``, if
    given, makes a context manager entered around that call (a profiler
    window).  ``sets`` reuses the write sets of an earlier call with the
    same arguments."""
    d = economics_db(records=records, payload_words=payload_words,
                     device=device, impl=impl)
    if sets is None:
        sets = workloads.worker_write_sets(
            workers, txns_per_worker, WRITES_PER_TXN, records, skew=skew,
            seed=SEED, shared=shared)
    groups = groups_of(d, sets)
    with (around() if around else contextlib.nullcontext()):
        t0 = time.perf_counter()
        masks = d.commit_grouped(groups, max_retries=MAX_RETRIES)
        host_s = time.perf_counter() - t0
    stats = dict(d.txn_stats)
    attempts = [[s.attempts for s in g] for g in groups]
    txn_ids = [[s.txn_id for s in g] for g in groups]
    stats["attempts"] = stats["commits"] + stats["aborts"]
    stats["abort_rate"] = stats["aborts"] / max(stats["attempts"], 1)
    if keep:
        return stats, sets, attempts, txn_ids, {
            "db": d, "groups": groups, "masks": masks, "host_s": host_s}
    return stats, sets, attempts, txn_ids


# ---------------------------------------------- panel (b): trace + sim --


def row_bytes(payload_words: int) -> int:
    """Wire bytes of one install WRITE: the payload words and the version
    word, 4 bytes each."""
    return 4 * (payload_words + 1)


def commit_trace(write_sets, attempts, txn_ids, shards, placement, *,
                 records: int = RECORDS, row_bytes: int = ROW_BYTES) -> list:
    """Synthesize the grouped-commit wave (plus its retry rounds) as a
    simulator trace.  Per worker agent, per attempt round, each verb of
    the commit is ONE doorbell-batched call, split into a loopback part
    (dst == the worker's own node: skips the wire, still pays the NIC)
    and a remote part (a rotating remote dst).  Retry rounds re-emit
    their verbs behind the refresh READ and a backoff ``compute`` event
    (what ``Database._backoff`` emits on a traced transport); the grant
    exchange is ONE round for the whole wave, each participating node
    posting one doorbell with the full grant vector.  Emitting it per
    node rather than as a collective keeps the per-node NIC cost while
    putting W flows on the wire instead of W*(W-1): the fair-share scan
    is O(flows) per transition, and the collective expansion made W=64
    points take minutes.  An install WRITE puts ``row_bytes`` on the
    wire (the JAX benchmark's 36 by default)."""
    events = []
    seq = 0

    def emit(verb, msgs, nbytes, agent, src, dst, compute_s=0.0):
        nonlocal seq
        events.append(sim.SimEvent(
            seq=seq, verb=verb, msgs=float(msgs), nbytes=float(nbytes),
            agent=agent, src=src, dst=dst, compute_s=compute_s))
        seq += 1

    def emit_split(verb, n_local, n_remote, row_bytes, agent, node):
        if n_local:
            emit(verb, n_local, n_local * row_bytes, agent, node, node)
        if n_remote:
            emit(verb, n_remote, n_remote * row_bytes, agent, node, None)

    max_round = max((a for per_w in attempts for a in per_w), default=1)
    for rnd in range(1, max_round + 1):
        round_live = 0
        live_nodes = set()
        for w, (wsets, att, tids) in enumerate(
                zip(write_sets, attempts, txn_ids)):
            agent, node = f"w{w}", int(placement[w])
            live = [i for i, a in enumerate(att) if a >= rnd]
            if not live:
                continue
            round_live += len(live)
            live_nodes.add(node)
            recs = np.concatenate([np.asarray(wsets[i]).ravel()
                                   for i in live])
            homes = home_shard(recs, records, shards)
            n_loc = int(np.sum(homes == node))
            n_rem = int(recs.size - n_loc)
            if rnd > 1:
                worst = max(backoff_slots(tids[i] or 0, rnd - 1)
                            for i in live)
                if worst:
                    emit("compute", 0, 0, agent, node, None,
                         compute_s=worst * BACKOFF_SLOT_S)
                emit_split("read", n_loc, n_rem, READ_BYTES, agent, node)
            emit_split("cas", n_loc, n_rem, CAS_BYTES, agent, node)
            emit_split("write", n_loc, n_rem, row_bytes, agent, node)
        for node in sorted(live_nodes):
            emit("exchange", 1, 4 * round_live, "grant", node, None)
    return events


def throughput(profile, write_sets, attempts, txn_ids, commits, *,
               shards, placement, records: int = RECORDS,
               row_bytes: int = ROW_BYTES):
    """(committed txns / simulated makespan, the SimResult)."""
    trace = commit_trace(write_sets, attempts, txn_ids, shards, placement,
                         records=records, row_bytes=row_bytes)
    res = sim.FabricSim(profile, nodes=shards, window=AGENT_WINDOW,
                        windows={"grant": 0}).run(trace)
    return commits / res.makespan, res


# -------------------------------------------------------------- panels --


def economics_panel(econ: dict, workers, rows: list) -> dict:
    """Panel (a)'s rows and assert, from ``econ[skew][W]`` =
    :func:`run_economics` results."""
    for sname in econ:
        for W in workers:
            st = econ[sname][W][0]
            rows.append((f"fig_scale/econ_{sname}_w{W}", 0.0,
                         f"commits_{st['commits']}_aborts_{st['aborts']}"
                         f"_retries_{st['retries']}"))
    for W in workers:
        uni = econ["uniform"][W][0]["abort_rate"]
        hot = econ["zipf12"][W][0]["abort_rate"]
        # skew costs aborts at every scale
        assert hot > uni, \
            (f"w{W}: zipf12 abort rate {hot:.3f} not above "
             f"uniform {uni:.3f}")
    return {sname: {str(W): econ[sname][W][0]["abort_rate"]
                    for W in workers} for sname in econ}


def throughput_panel(econ: dict, workers, profiles, rows: list, *,
                     records: int = RECORDS,
                     row_bytes: int = ROW_BYTES) -> dict:
    """Panel (b): throughput against workers, per profile and skew."""
    out = {}
    for pname in profiles:
        prof = netsim.get_profile(pname)
        curves = {}
        for sname in econ:
            curve = {}
            for W in workers:
                st, sets, att, tids = econ[sname][W][:4]
                ident = assign_workers(W, W, locality=True)
                tput, _ = throughput(prof, sets, att, tids, st["commits"],
                                     shards=W, placement=ident,
                                     records=records, row_bytes=row_bytes)
                curve[str(W)] = tput
                rows.append((f"fig_scale/{pname}_{sname}_w{W}",
                             1e6 / tput, f"{tput:,.0f}tps"))
            curves[sname] = curve
        out[pname] = curves
        up_uni = curves["uniform"]["32"] / curves["uniform"]["4"]
        up_hot = curves["zipf12"]["32"] / curves["zipf12"]["4"]
        # near-linear uncontended, abort-driven flattening
        assert up_uni >= 3.0, \
            f"{pname}: uniform 4->32 workers only {up_uni:.2f}x"
        assert up_hot < up_uni, \
            (f"{pname}: zipf12 growth {up_hot:.2f}x not below "
             f"uniform {up_uni:.2f}x")
        rows.append((f"fig_scale/{pname}_scaling", 0.0,
                     f"uniform_{up_uni:.1f}x_zipf12_{up_hot:.1f}x"))
    return out


def locality_panel(loc_econ, profiles, rows: list, *,
                   records: int = RECORDS, row_bytes: int = ROW_BYTES,
                   W: int = LOCALITY_WORKERS) -> dict:
    """Panel (c): the home-affine Zipf(1.2) run ``loc_econ`` priced under
    both placements."""
    st, sets, att, tids = loc_econ[:4]
    out = {}
    for pname in profiles:
        prof = netsim.get_profile(pname)
        pts = {}
        for loc in (True, False):
            placement = assign_workers(W, W, locality=loc)
            tput, _ = throughput(prof, sets, att, tids, st["commits"],
                                 shards=W, placement=placement,
                                 records=records, row_bytes=row_bytes)
            frac = float(np.mean([local_fraction(
                np.asarray(sets[w]).ravel(), placement[w], records, W)
                for w in range(W)]))
            pts["on" if loc else "off"] = {"tps": tput,
                                           "local_fraction": frac}
            rows.append((f"fig_scale/{pname}_locality_"
                         f"{'on' if loc else 'off'}", 1e6 / tput,
                         f"{tput:,.0f}tps_local{frac:.2f}"))
        out[pname] = pts
        if prof.rdma:
            # placement alone buys throughput under skew
            assert pts["on"]["tps"] > pts["off"]["tps"], \
                (f"{pname}: locality on {pts['on']['tps']:.0f} <= "
                 f"off {pts['off']['tps']:.0f}")
    return out


def run(profiles=None, timed=False, *, workers=WORKERS, skews=None,
        device=None, econ=None):
    """The whole figure at the JAX benchmark's sizes: (rows, extras).
    ``econ`` reuses the panel (a) economics of an earlier
    :func:`run_economics` at these sizes on ``device`` ({skew: {W: its
    first four results}}).  Under ``timed`` it adds the JAX benchmark's
    ``measured_s``: one grouped wave at 32 workers, Zipf(1.2), and one
    point of panel (b)'s simulated curve."""
    profiles = tuple(profiles) if profiles else DEFAULT_PROFILES
    skews = dict(skews or SKEWS)
    rows: list = []
    if econ is None:
        econ = {sname: {W: run_economics(W, s, device=device)
                        for W in workers} for sname, s in skews.items()}
    abort_rate = economics_panel(econ, workers, rows)
    retries = {sname: {str(W): econ[sname][W][0]["retries"]
                       for W in workers} for sname in skews}
    tput = throughput_panel(econ, workers, profiles, rows)
    loc_econ = run_economics(LOCALITY_WORKERS, SKEWS["zipf12"],
                             shared=False, device=device)
    locality = locality_panel(loc_econ, profiles, rows)
    txn = econ["zipf12"][max(workers)][0]
    extras = {"workers": list(workers), "skews": dict(skews),
              "throughput": tput, "abort_rate": abort_rate,
              "retries": retries, "locality": locality,
              "txn": {k: v for k, v in txn.items()
                      if not isinstance(v, (list, np.ndarray))}}
    if timed:
        prof0 = netsim.get_profile(profiles[0])
        st, sets, att, tids = econ["zipf12"][32][:4]
        ident = assign_workers(32, 32, locality=True)
        extras["measured_s"] = {
            "fig_scale/grouped_commit_32w": timing.device_time_s(
                lambda: run_economics(32, SKEWS["zipf12"], device=device),
                warmup=1, k=3, device=resolve_device(device)),
            "fig_scale/sim_curve_point": timing.device_time_s(
                lambda: throughput(prof0, sets, att, tids, st["commits"],
                                   shards=32, placement=ident),
                warmup=1, k=3)}
    return rows, extras


def read_back(db: Database, sessions, *, sample: int = 256) -> dict:
    """Every committed write reads back: each written row holds its last
    committed writer's payload and cid (``checkout.check_readback``)."""
    return checkout.check_readback(db, sessions, sample=sample,
                                   table="acct")


def store_equal(a: Database, b: Database, table: str = "acct") -> bool:
    """Every store leaf of ``table`` equal, bit for bit."""
    sa, sb = a.table(table).store, b.table(table).store
    return all(torch.equal(sa[k], sb[k]) for k in sa)
