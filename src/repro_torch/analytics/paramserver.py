"""NAM-style parameter server for advanced analytics (paper §6); a port of
``repro.analytics.paramserver``.

Model state lives in network-attached memory, and workers touch it with
the same one-sided verbs that rebuilt OLTP (§4) and OLAP (§5):

  * **parameters are regions**: the flattened model is a ``(num_shards,
    shard_len)`` f32 region (``ps/params``) of a
    :class:`~repro_torch.fabric.NamPool`, its rows in the JAX package's
    flatten order (dict keys sorted), so the rows, the compression blocks
    and their scales are the JAX server's bit for bit;
  * **pull is a one-sided READ** of the shards, cached per worker; a
    **bounded-staleness gate** (at most ``staleness`` epochs behind)
    decides when the cache must be refreshed;
  * **the epoch is a FETCH_ADD counter**: the ``ps/epoch`` u32 word (an
    int32 bit pattern) is bumped once per applied push, so a pull tells
    how stale its cache is with one READ of one word;
  * **push is a routed, compressed write**: gradients are quantized by
    :mod:`repro_torch.train.grad_compress` (int8 plus per-block scales,
    an error-feedback residual per worker) and travel to their owner
    shards through ``transport.route()``; on the card the route runs the
    hand-written rank and scatter kernels.

All protocol logic (the gate, compression, the apply rule) runs on the
client side against counted verbs.  ``apply_fn(params_tree, grads_tree)
-> params_tree`` defaults to SGD; the trainer passes its optimizer's
update.  An attached schedule recorder (``fabric.check``) sees the
epoch declaration, each pull and each push's install.
"""
from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch import fabric
from repro_torch._bits import u32
from repro_torch.train import grad_compress as gc
from repro_torch.tree import ravel, tree_map

# modeled cluster size for the single-shard case: the same §5.4
# deployment constant the db facade uses
DEFAULT_SHARDS = 4


def row_layout(n_values: int, *, n: int = 1, num_shards=None,
               block: int = 256) -> tuple:
    """(S, L) of the ``ps/params`` rows for ``n_values`` parameters on a
    transport of ``n`` shards: S rows (``num_shards``, by default
    DEFAULT_SHARDS rounded up to a multiple of n, so every fabric shard
    owns equal rows) of L values, L the ceiling of n_values / S rounded
    up to a whole number of compression blocks."""
    S = int(num_shards) if num_shards else n * max(
        1, -(-DEFAULT_SHARDS // n))
    if S % n != 0:
        raise ValueError(f"num_shards={S} not a multiple of "
                         f"transport shards n={n}")
    L = -(-n_values // S)                              # ceil
    L += (-L) % block                                  # block-align rows
    return S, L


@dataclass
class _Cache:
    """One worker's pulled view (already unraveled: a cache hit is free,
    not a full-model copy) and its epoch."""
    tree: object
    epoch: int


def sgd_apply(lr: float = 0.1) -> Callable:
    """Default server-side apply rule: plain SGD on the pushed gradient."""
    def apply(params, grads):
        return tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads)
    return apply


class ParameterServer:
    """Partitioned model parameters in network-attached memory.

    params:     template tree of tensors (also the initial value).
    transport:  a fabric transport (``LocalTransport()`` by default, on
                the card).
    staleness:  bounded-staleness k: a pull may serve a cached view at
                most k epochs behind the epoch counter (k = 0 is fully
                synchronous).
    block:      grad_compress block size.
    compress:   False pushes raw f32 gradients (the parity baseline).
    apply_fn:   server apply rule on trees; default SGD(lr).
    num_shards: parameter partitions; a multiple of ``transport.n`` (each
                fabric shard owns ``num_shards / n`` rows).
    """

    def __init__(self, params, *, transport=None, staleness: int = 0,
                 block: int = 256, compress: bool = True,
                 apply_fn: Optional[Callable] = None, lr: float = 0.1,
                 num_shards: Optional[int] = None):
        self.transport = transport or fabric.LocalTransport()
        self.staleness = int(staleness)
        self.block = int(block)
        self.compress = bool(compress)
        self.apply_fn = apply_fn or sgd_apply(lr)
        if self.staleness < 0:
            raise ValueError(f"staleness must be >= 0, got {staleness}")
        self.device = self.transport.device

        flat, self._unravel = ravel(params)
        self._n_values = flat.numel()
        S, L = row_layout(self._n_values, n=self.transport.n,
                          num_shards=num_shards, block=self.block)
        self.num_shards, self.shard_len = S, L

        self.pool = fabric.NamPool()
        self.pool.alloc("ps/params", (S, L), torch.float32, (None, None))
        self.pool.alloc("ps/epoch", (1,), torch.int32, ("replicated",))
        self._params = self._to_shards(flat)
        del flat
        self._epoch = torch.zeros((1,), dtype=torch.int32,
                                  device=self.device)
        self._word0 = torch.zeros((1,), dtype=torch.int32,
                                  device=self.device)
        self._one = torch.ones((1,), dtype=torch.int32, device=self.device)
        self._rows = torch.arange(S, dtype=torch.int32, device=self.device)
        self._cache: dict = {}
        self._residuals: dict = {}
        rec = getattr(self.transport, "recorder", None)
        if rec is not None:
            rec.declare_epoch("ps/epoch", params_region="ps/params",
                              staleness=self.staleness)

    def _agent(self, worker):
        """Attribute this worker's verbs to its own logical agent in an
        attached schedule recorder (no-op without one)."""
        rec = getattr(self.transport, "recorder", None)
        return rec.agent(f"ps/worker{worker}") if rec is not None \
            else nullcontext()

    # ------------------------------------------------------------ layout --

    def _to_shards(self, flat) -> torch.Tensor:
        S, L = self.num_shards, self.shard_len
        flat = flat.to(device=self.device, dtype=torch.float32)
        return F.pad(flat, (0, S * L - flat.numel())).reshape(S, L)

    def _to_tree(self, shards):
        return self._unravel(shards.reshape(-1)[:self._n_values])

    # ------------------------------------------------------------- state --

    @property
    def epoch(self) -> int:
        """Number of pushes applied (the FETCH_ADD counter's value)."""
        return int(u32(self._epoch[0]))

    def current_params(self):
        """Server-side view (no wire traffic), for checkpointing."""
        return self._to_tree(self._params)

    def wire_bytes_per_push(self) -> tuple:
        """(compressed, raw-f32) wire bytes of one full gradient push."""
        S, L = self.num_shards, self.shard_len
        comp = S * L + S * (L // self.block) * 4
        return (comp if self.compress else S * L * 4), S * L * 4

    # -------------------------------------------------------------- pull --

    def pull(self, worker: int = 0):
        """Bounded-stale parameter fetch: returns ``(params, epoch)``.

        One READ of the epoch word decides freshness; only when the
        worker's cached view is more than ``staleness`` epochs behind does
        the pull READ the parameter shards.  The returned epoch is never
        older than ``current - staleness``."""
        t = self.transport
        with self._agent(worker):
            cur = int(u32(t.read(self._epoch, self._word0,
                                 region="ps/epoch")[0]))
            cached = self._cache.get(worker)
            if cached is not None and cur - cached.epoch <= self.staleness:
                self._note_pull(worker, cached.epoch, cur)
                return cached.tree, cached.epoch
            # drop the stale view before the READ allocates the fresh one
            self._cache.pop(worker, None)
            shards = t.read(self._params, self._rows, region="ps/params")
            tree = self._to_tree(shards)
            self._cache[worker] = _Cache(tree, cur)
            self._note_pull(worker, cur, cur)
        return tree, cur

    def _note_pull(self, worker, observed: int, current: int):
        rec = getattr(self.transport, "recorder", None)
        if rec is not None:
            rec.note_pull(region="ps/params", worker=worker,
                          observed_epoch=observed, current_epoch=current,
                          staleness=self.staleness)

    # -------------------------------------------------------------- push --

    def push(self, grads, worker: int = 0) -> int:
        """Push one gradient: compress (error feedback), route the codes to
        their owner shards, apply server-side, bump the epoch counter.
        Returns the new epoch."""
        with record_function("ps.compress"):
            flat = self._to_shards(ravel(grads)[0])
            if self.compress:
                res = self._residuals.get(worker)
                if res is None:
                    res = torch.zeros_like(flat)
                codes, scale, self._residuals[worker] = \
                    gc.compress_with_feedback(flat, res, block=self.block)
                del res
                payload = (codes.reshape(flat.shape),
                           scale.reshape(flat.shape[0], -1))
            else:
                payload = (flat,)
            del flat
        with self._agent(worker):
            recv = self.transport.run(self._push_body, payload, False)
            del payload
            with record_function("ps.apply"):
                g_tree = self._to_tree(recv)
                new_tree = self.apply_fn(self._to_tree(self._params),
                                         g_tree)
                del g_tree, recv
            # server-local install: the apply runs at the owner shard, so
            # the write never crosses the wire; it is logged record-only
            # for the race detector
            with record_function("ps.install"):
                self._params = self._to_shards(ravel(new_tree)[0])
                del new_tree
                self.transport.record_access("WRITE", "ps/params",
                                             self._rows,
                                             region_len=self.num_shards)
                fetched, self._epoch = self.transport.fetch_add(
                    self._epoch, self._word0, self._one, region="ps/epoch")
        return int(u32(fetched[0])) + 1

    def _push_body(self, *leaves):
        """Per-shard protocol body (runs under ``transport.run``): route
        this shard's gradient rows to their owner through the fabric's
        fixed-buffer router, then decode the received rows.

        Each fabric shard owns ``num_shards / n`` contiguous parameter
        rows, so under ``MeshTransport`` a shard's local slice routes to
        itself, and under ``LocalTransport`` everything loops back through
        the counted router; either way the wire pays compressed bytes."""
        t = self.transport
        rows = leaves[0].shape[0]              # local rows on this shard
        me = t.shard_index()
        dev = leaves[0].device
        dest = torch.full((rows,), me, dtype=torch.int32, device=dev)
        if self.compress:
            fields = {"codes": leaves[0], "scale": leaves[1]}
        else:
            fields = {"grad": leaves[0]}
        with record_function("ps.route"):
            res = t.route(fields, dest, cap=rows)
        # my requests landed in receive slots [me*cap, (me+1)*cap)
        slots = me * rows + torch.arange(rows, device=dev)

        def take(v):
            return v.index_select(0, slots)

        with record_function("ps.decompress"):
            if self.compress:
                codes = take(res.fields["codes"])
                scale = take(res.fields["scale"])
                del res
                return gc.decompress(codes.reshape(-1, self.block),
                                     scale.reshape(-1), codes.shape,
                                     block=self.block)
            return take(res.fields["grad"])

    # -------------------------------------------------------- accounting --

    def fabric_stats(self) -> dict:
        """Cumulative per-verb message/byte counters."""
        return self.transport.stats()
