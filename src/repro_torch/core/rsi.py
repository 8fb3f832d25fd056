"""RSI — RDMA-based Snapshot Isolation (paper §4.2), in PyTorch.

The port of ``repro.core.rsi``.  Store layout (paper Table 1): per record a
1-bit lock | 31-bit CID word, followed by version slots (newest first),
plus the timestamp bitvector.  The client drives the commit with
one-sided verbs:

  msg 1: get a CID from the client's slice of the timestamp bitvector
  msg 2: validate+lock every write with one CAS  (one routed round trip)
  msg 3: install versions with WRITEs, release locks, flip the bitvector
         bit (unsignaled)

Losers release the locks they won (restore the old word).  Prepare and
install are routed to home shards through ``transport.route`` with one
:class:`~repro_torch.fabric.router.RoutePlan`; on the card the plan, both
scatters and the CAS run the hand-written kernels.

Words, CIDs and payload are int32 bit patterns of the JAX package's u32
values (:mod:`repro_torch._bits`); :func:`store_from_numpy`,
:func:`store_to_numpy` and :meth:`TxnBatch.from_numpy` convert bit for
bit.  **The commit updates the store's tensors in place** (the JAX commit
returns a new store): the ``(ok, store)`` return keeps JAX's signature,
and the returned store holds the same tensors.  Callers that need the old
state clone it first.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch._bits import (CID_MASK, LOCK_BIT, M32, np_to_i32, np_u32,
                               put_rows, resolve_device, to_i32, u32)
from repro_torch.fabric import LocalTransport

WORD = torch.int32
LEAVES = ("words", "payload", "cids", "bitvec")


@dataclass(frozen=True)
class StoreCfg:
    num_records: int
    payload_words: int = 4        # m-bit record as 32-bit words
    version_slots: int = 1        # paper's current impl: n = 1
    num_timestamps: int = 60_000  # paper's bitvector size


def init_store(cfg: StoreCfg, device=None) -> dict:
    """words[r] = lock|CID; payload (R, slots, m); cids (R, slots);
    bitvec (num_timestamps,) bool — zeros on ``device`` (the card unless
    the caller asks for the CPU)."""
    dev = resolve_device(device)
    R = cfg.num_records
    return {
        "words": torch.zeros((R,), dtype=WORD, device=dev),
        "payload": torch.zeros((R, cfg.version_slots, cfg.payload_words),
                               dtype=WORD, device=dev),
        "cids": torch.zeros((R, cfg.version_slots), dtype=WORD, device=dev),
        "bitvec": torch.zeros((cfg.num_timestamps,), dtype=torch.bool,
                              device=dev),
    }


def store_from_numpy(d: dict, device=None) -> dict:
    """The JAX store as numpy arrays (u32 words/payload/cids, bool bitvec)
    -> the port's store, bit for bit."""
    dev = resolve_device(device)
    out = {k: torch.from_numpy(np_to_i32(d[k])).to(dev)
           for k in ("words", "payload", "cids")}
    out["bitvec"] = torch.from_numpy(np.array(d["bitvec"], bool)).to(dev)
    return out


def store_to_numpy(store: dict) -> dict:
    """The port's store -> numpy in the JAX package's dtypes."""
    out = {k: np_u32(store[k]) for k in ("words", "payload", "cids")}
    out["bitvec"] = store["bitvec"].detach().cpu().numpy().astype(bool)
    return out


def highest_committed(bitvec) -> torch.Tensor:
    """Highest consecutive set bit (paper's read-timestamp rule), as a 0-d
    int32 word."""
    consec = torch.cumprod(bitvec.to(torch.int64), 0)
    return to_i32(consec.sum())


@dataclass(frozen=True)
class TxnBatch:
    """W fixed write slots per txn (record -1 = unused).

    write_recs: (T, W) int32; read_cids: (T, W) word — the RID each
    record was read under; new_payload: (T, W, m) words; cid: (T,) words,
    pre-assigned commit timestamps (bitvector slots).  Words are int32
    bit patterns of u32 values.
    """
    write_recs: torch.Tensor
    read_cids: torch.Tensor
    new_payload: torch.Tensor
    cid: torch.Tensor

    @classmethod
    def from_numpy(cls, write_recs, read_cids, new_payload, cid,
                   device=None) -> "TxnBatch":
        """Build from numpy (recs int, the rest u32), bit for bit."""
        dev = resolve_device(device)
        return cls(
            write_recs=torch.from_numpy(
                np.asarray(write_recs, np.int32).copy()).to(dev),
            read_cids=torch.from_numpy(np_to_i32(read_cids)).to(dev),
            new_payload=torch.from_numpy(np_to_i32(new_payload)).to(dev),
            cid=torch.from_numpy(np_to_i32(cid)).to(dev))


# ------------------------------------------------------------ the rounds --

def _prepare(wrecs, rcids, prio, n: int, r_local: int):
    """Home-shard dest and the payload-free CAS request of one wave."""
    Tl, W = wrecs.shape
    home = torch.div(wrecs, r_local, rounding_mode="floor")
    dest = torch.where(wrecs >= 0, home, n).reshape(-1)
    req = {"rec": wrecs.reshape(-1),
           "exp": (rcids & CID_MASK).reshape(-1),
           "prio": prio.to(torch.int32).repeat_interleave(W),
           "slot": torch.arange(Tl * W, dtype=torch.int32,
                                device=wrecs.device)}
    return dest, req


def _lock(transport, words, res, r_local: int, region_ns: str):
    """Validate+lock the routed requests on my records (global priority)."""
    r = res.fields
    lrec = torch.where(res.valid > 0, r["rec"] % r_local, -1)
    return transport.cas(words, lrec, r["exp"], LOCK_BIT | r["exp"],
                         priority=r["prio"], region=region_ns + "words")


def _grants(transport, ok, res, wrecs, exchange_chunks: int):
    """Grants return to their requesters' slots; a txn commits iff every
    used write slot was granted."""
    Tl, W = wrecs.shape
    grant = transport.exchange(ok.to(torch.int32), exchange_chunks)
    granted = torch.zeros((Tl * W,), dtype=torch.int32, device=wrecs.device)
    granted.index_add_(0, res.sent["slot"].to(torch.int64),
                       grant * res.sent_valid)
    used = wrecs >= 0
    txn_ok = ((granted.reshape(Tl, W) > 0) | ~used).all(1) & used.any(1)
    return txn_ok, granted


def _install_fields(wrecs, rcids, npay, cid, txn_ok, granted):
    """Install requests: committed txns write their CID and payload,
    losers restore the words they locked."""
    Tl, W = wrecs.shape
    commit_req = txn_ok.repeat_interleave(W) & (granted > 0)
    release_req = (granted > 0) & ~commit_req
    exp_flat = (rcids & CID_MASK).reshape(-1)
    cid_flat = (cid & CID_MASK).repeat_interleave(W)
    inst = {"rec": wrecs.reshape(-1),
            "val": torch.where(commit_req, cid_flat, exp_flat),
            "npay": npay.reshape(Tl * W, -1),
            "do_pay": commit_req.to(torch.int32)}
    return inst, commit_req | release_req


def _install(transport, words, payload, cids, res2, r_local: int,
             region_ns: str):
    """Apply the routed installs: the word WRITEs, then (in place) the
    version shift of committed rows and the new version in slot 0."""
    r2, v2 = res2.fields, res2.valid
    lrec2 = torch.where(v2 > 0, r2["rec"] % r_local, -1)
    words = transport.write(words, lrec2, r2["val"],
                            region=region_ns + "words")
    pay_idx = torch.where((r2["do_pay"] > 0) & (v2 > 0), lrec2, -1)
    sel = pay_idx >= 0
    # the committed rows: the new version in slot 0, the older ones
    # shifted by one (each row is read before any is written)
    rows = pay_idx.clamp(min=0).to(torch.int64)
    put_rows(payload, pay_idx, torch.cat(
        [r2["npay"].unsqueeze(1), payload[rows, :-1]], 1), sel)
    put_rows(cids, pay_idx, torch.cat(
        [r2["val"].unsqueeze(1), cids[rows, :-1]], 1), sel)
    # install bytes are billed to the routed buffer; log the scatter
    # record-only for an attached race detector
    transport.record_access("WRITE", region_ns + "payload", pay_idx,
                            region_len=payload.shape[0])
    transport.record_access("WRITE", region_ns + "cids", pay_idx,
                            region_len=payload.shape[0])
    return words


def _burn(transport, bitvec, cid, me, region_ns: str):
    """[msg 3, unsignaled] clients flip their own bitvector bits; aborted
    txns burn their slot too."""
    bv_local = bitvec.shape[0]
    cbit = cid.to(torch.int32) - me * bv_local
    inr = (cbit >= 0) & (cbit < bv_local)
    put_rows(bitvec, cbit, torch.ones_like(inr), inr)
    transport.record_access("WRITE", region_ns + "bitvec",
                            torch.where(inr, cbit, -1), region_len=bv_local)
    return bitvec


def _pack_store(words, payload, cids, bitvec) -> dict:
    return {"words": words, "payload": payload, "cids": cids,
            "bitvec": bitvec}


# -------------------------------------------------------------- commits --

def commit(store, txns: TxnBatch, *, transport=None, priority=None,
           chunks: int = 1, exchange_chunks: int = 1, region_ns: str = ""):
    """Commit a batch of concurrent transactions over a fabric transport.
    Returns (committed (T,) bool, store) — the store's tensors updated in
    place.

    transport: default ``LocalTransport`` on the store's device.
    priority: (T,) int32 arbitration order (lower wins; default = row
      order).  chunks: pipeline the routed prepare/install buffers; must
      divide T*W.  exchange_chunks: pipeline the grant exchange the same
      way (:func:`commit_grouped` sets it to the group size).
    region_ns: region-name prefix for an attached schedule recorder.
    """
    if transport is None:
        transport = LocalTransport(device=store["words"].device)
    T, _ = txns.write_recs.shape
    if priority is None:
        priority = torch.arange(T, dtype=torch.int32,
                                device=txns.write_recs.device)
    n = transport.n
    recorder = getattr(transport, "recorder", None)
    if recorder is not None:
        recorder.begin_wave(f"{region_ns}commit")

    def body(words, payload, cids, bitvec, wrecs, rcids, npay, cid, prio):
        Tl, W = wrecs.shape
        r_local = words.shape[0]       # records per home shard
        dest, req = _prepare(wrecs, rcids, prio, n, r_local)
        # both rounds travel to the same home shards: bin once
        plan = transport.plan_route(dest, cap=Tl * W)
        res = transport.route(req, plan=plan, chunks=chunks)
        ok, words = _lock(transport, words, res, r_local, region_ns)
        txn_ok, granted = _grants(transport, ok, res, wrecs, exchange_chunks)
        inst, act = _install_fields(wrecs, rcids, npay, cid, txn_ok, granted)
        res2 = transport.route(inst, plan=plan, mask=act, chunks=chunks)
        words = _install(transport, words, payload, cids, res2, r_local,
                         region_ns)
        bitvec = _burn(transport, bitvec, cid, transport.shard_index(),
                       region_ns)
        return txn_ok, words, payload, cids, bitvec

    txn_ok, *leaves = transport.run(
        body,
        (store["words"], store["payload"], store["cids"], store["bitvec"],
         txns.write_recs, txns.read_cids, txns.new_payload, txns.cid,
         priority),
        out_reps=(False,) * 5)
    if recorder is not None:
        recorder.fence("commit-complete")
    return txn_ok, _pack_store(*leaves)


def commit_pipelined(store, waves, *, transport=None, priority=None,
                     chunks: int = 1, region_ns: str = ""):
    """Commit K *dependent* waves with wave i's install round trip
    overlapping wave i+1's prepare round trip (issued async, waited on
    only when applied).  Same bits and counters as K sequential
    :func:`commit` calls: a prepare reads only its txn batch, never the
    store.  Returns (txn_ok list, store)."""
    if transport is None:
        transport = LocalTransport(device=store["words"].device)
    K = len(waves)
    if K == 0:
        return [], store
    if priority is None:
        priority = [torch.arange(w.write_recs.shape[0], dtype=torch.int32,
                                 device=w.write_recs.device) for w in waves]
    n = transport.n
    recorder = getattr(transport, "recorder", None)

    def body(words, payload, cids, bitvec, *flat):
        wv = [flat[5 * i:5 * (i + 1)] for i in range(K)]
        r_local = words.shape[0]

        def issue_prepare(wrecs, rcids, prio):
            dest, req = _prepare(wrecs, rcids, prio, n, r_local)
            plan = transport.plan_route(dest, cap=wrecs.numel())
            return plan, transport.route_async(req, plan=plan, chunks=chunks)

        outs = []
        prep = issue_prepare(wv[0][0], wv[0][1], wv[0][4])
        for i in range(K):
            wrecs, rcids, npay, cid, _ = wv[i]
            if recorder is not None:
                recorder.begin_wave(f"{region_ns}commit[{i}]")
            plan, prep_c = prep
            res = prep_c.wait()          # prepare round-trip fence, wave i
            ok, words = _lock(transport, words, res, r_local, region_ns)
            txn_ok, granted = _grants(transport, ok, res, wrecs, 1)
            outs.append(txn_ok)
            inst, act = _install_fields(wrecs, rcids, npay, cid, txn_ok,
                                        granted)
            inst_c = transport.route_async(inst, plan=plan, mask=act,
                                           chunks=chunks)
            if i + 1 < K:
                # the overlap: wave i+1's prepare goes on the wire while
                # wave i's install is in flight
                prep = issue_prepare(wv[i + 1][0], wv[i + 1][1],
                                     wv[i + 1][4])
            res2 = inst_c.wait()         # install round-trip fence, wave i
            words = _install(transport, words, payload, cids, res2, r_local,
                             region_ns)
            bitvec = _burn(transport, bitvec, cid, transport.shard_index(),
                           region_ns)
        return tuple(outs) + (words, payload, cids, bitvec)

    flat_args = []
    for w, p in zip(waves, priority):
        flat_args += [w.write_recs, w.read_cids, w.new_payload, w.cid, p]
    out = transport.run(
        body,
        (store["words"], store["payload"], store["cids"], store["bitvec"],
         *flat_args),
        out_reps=(False,) * (K + 4))
    if recorder is not None:
        recorder.fence("commit-complete")
    return list(out[:K]), _pack_store(*out[K:])


def concat_group(groups, priority=None):
    """Coalesce K per-session :class:`TxnBatch`es into ONE batch: write
    slots padded to the widest W (record -1 = unused), stacked along T;
    default priority = global row order.  Returns (batch, priority (T,)
    int32, sizes)."""
    if not groups:
        raise ValueError("concat_group needs at least one TxnBatch")
    W = max(g.write_recs.shape[1] for g in groups)

    def pad(a, fill):
        t, w = a.shape[0], a.shape[1]
        if w == W:
            return a
        extra = torch.full((t, W - w) + tuple(a.shape[2:]), fill,
                           dtype=a.dtype, device=a.device)
        return torch.cat([a, extra], dim=1)

    batch = TxnBatch(
        write_recs=torch.cat([pad(g.write_recs, -1) for g in groups]),
        read_cids=torch.cat([pad(g.read_cids, 0) for g in groups]),
        new_payload=torch.cat([pad(g.new_payload, 0) for g in groups]),
        cid=torch.cat([g.cid for g in groups]))
    sizes = [int(g.write_recs.shape[0]) for g in groups]
    dev = batch.write_recs.device
    if priority is None:
        priority = torch.arange(sum(sizes), dtype=torch.int32, device=dev)
    else:
        priority = torch.cat([torch.as_tensor(p, dtype=torch.int32,
                                              device=dev) for p in priority])
    return batch, priority, sizes


def _group_chunks(groups, chunks):
    """Doorbells of a grouped round: one chunk per session, or 1 when the
    group's slots do not split evenly."""
    if chunks is not None:
        return int(chunks)
    K = len(groups)
    W = max(g.write_recs.shape[1] for g in groups)
    slots = sum(int(g.write_recs.shape[0]) for g in groups) * W
    return K if K and slots % K == 0 else 1


def commit_grouped(store, groups, *, transport=None, priority=None,
                   chunks=None, region_ns: str = ""):
    """Group commit: K sessions' batches in ONE routed prepare/install
    round trip (one plan build, three collectives), pipelined in K chunks
    so the wire counters equal K solo commits.  Returns (list of
    per-group txn_ok, store)."""
    gch = _group_chunks(groups, chunks)
    batch, prio, sizes = concat_group(groups, priority)
    ok, store = commit(store, batch, transport=transport, priority=prio,
                       chunks=gch, exchange_chunks=gch, region_ns=region_ns)
    return _split_sizes(ok, sizes), store


def commit_grouped_pipelined(store, grouped_waves, *, transport=None,
                             chunks=None, region_ns: str = ""):
    """Group commit composed with the async pipeline: each wave is a group
    of session batches, wave N+1's grouped prepare overlapping wave N's
    grouped install.  Returns (list of lists of per-group txn_ok, store)."""
    if not grouped_waves:
        return [], store
    batches, prios, sizes = [], [], []
    for groups in grouped_waves:
        b, p, s = concat_group(groups)
        batches.append(b)
        prios.append(p)
        sizes.append(s)
    wave_chunks = {_group_chunks(g, chunks) for g in grouped_waves}
    # one chunks= for all waves; mixed group shapes fall back to 1
    ch = wave_chunks.pop() if len(wave_chunks) == 1 else 1
    oks, store = commit_pipelined(store, batches, transport=transport,
                                  priority=prios, chunks=ch,
                                  region_ns=region_ns)
    return [_split_sizes(ok, s) for ok, s in zip(oks, sizes)], store


def _split_sizes(arr, sizes):
    out, off = [], 0
    for s in sizes:
        out.append(arr[off:off + s])
        off += s
    return out


def read_snapshot(store, recs, rid, *, transport=None, region_ns: str = ""):
    """Read records at snapshot ``rid``: the newest version with
    0 < CID <= rid (u32 order).  Returns (payload (..., m), cid, ok —
    False if no version is visible).  With a transport the gathers are
    its counted READs; without one, plain indexing."""
    if transport is not None:
        def rd(region, idx, name):
            return transport.read(region, idx, region=region_ns + name)
    else:
        def rd(region, idx, name):
            return region[idx.to(torch.int64)]
    cids = rd(store["cids"], recs, "cids")            # (..., slots)
    cu = u32(cids)
    vis = (cu <= (int(rid) & M32)) & (cu > 0)
    slot = vis.to(torch.int32).argmax(-1)             # first visible
    ok = vis.any(-1)
    pay_all = rd(store["payload"], recs, "payload")   # (..., slots, m)
    index = slot[..., None, None].expand(
        slot.shape + (1, pay_all.shape[-1]))
    pay = pay_all.gather(-2, index)[..., 0, :]
    cid = cids.gather(-1, slot[..., None])[..., 0]
    return pay, cid, ok
