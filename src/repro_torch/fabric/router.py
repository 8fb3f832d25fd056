"""The single request router (paper §5.2 software-managed buffers), in
PyTorch.

The port of ``repro.fabric.router``.  :func:`route` radix-partitions a
batch of requests by destination shard into fixed ``(n, cap)`` buffers
and hands the buffer to the transport's exchange (``None`` = stay local):

  * **fields** is a pytree (dicts, lists, tuples) of per-request tensors
    with leading dim A;
  * **dest** outside ``[0, n)`` is *filtered*: not sent, not a drop;
  * requests past a destination's ``cap`` are **dropped** and counted in
    ``RouteResult.dropped``;
  * ``chunks > 1`` pipelines the exchange chunk by chunk.

**Packed wire format.**  All leaves plus the valid lane travel in ONE
``(n*cap, row_words)`` buffer of 32-bit lanes (int32 bit patterns): each
leaf's row is viewed as 32-bit lanes (sub-word dtypes padded up to a
lane, bool as u8), the last lane is the valid mask.  Leaves are packed in
JAX's pytree order (dict keys sorted), so the lanes are bit-identical to
the JAX router's.

**Kernels.**  On a CUDA tensor, :func:`plan_route` runs the hand-written
rank kernel and every non-overlapped route runs the hand-written scatter
kernel, which appends the valid lane as each row lands
(``kernels/csrc/radix_partition.cu``).  The double-buffered
``overlap=True`` path gathers through the inverted plan in plain torch.

A :class:`RoutePlan` (:func:`plan_route`) precomputes the slot assignment,
so RSI's prepare and install bin once; ``mask=`` unsends requests from a
reused plan without re-ranking.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import bucket_ranks

WORD = torch.int32
WORD_BYTES = 4

__all__ = ["RouteResult", "RoutePlan", "plan_route", "route", "pack_fields",
           "unpack_fields", "packed_row_words", "bucket_ranks",
           "tree_flatten", "tree_unflatten", "chunked_all_to_all"]


@dataclass
class RouteResult:
    """Outcome of one routed batch.

    fields:     pytree of (n*cap, ...) buffers after the exchange.
    valid:      (n*cap,) int32 occupancy (the valid lane).
    dropped:    () int32 — requests lost to capacity overflow.
    sent:       pytree of (n*cap, ...) buffers as sent (the return key).
    sent_valid: (n*cap,) int32 occupancy of the sent buffers.
    """
    fields: Any
    valid: torch.Tensor
    dropped: torch.Tensor
    sent: Any
    sent_valid: torch.Tensor


# ----------------------------------------------------------- pytrees -----

class TreeDef:
    """Structure of a pytree of tensors: ``kind`` is "leaf", "dict",
    "list" or "tuple"; dict keys are kept sorted, as JAX orders them."""

    __slots__ = ("kind", "keys", "children")

    def __init__(self, kind, keys=(), children=()):
        self.kind, self.keys, self.children = kind, tuple(keys), tuple(
            children)

    def __eq__(self, other):
        return (isinstance(other, TreeDef) and self.kind == other.kind
                and self.keys == other.keys
                and self.children == other.children)

    def __repr__(self):
        return f"TreeDef({self.kind}, {self.keys}, {self.children})"


def tree_flatten(tree):
    """(leaves, TreeDef) of a pytree of tensors."""
    if isinstance(tree, torch.Tensor):
        return [tree], TreeDef("leaf")
    if isinstance(tree, dict):
        keys = sorted(tree)
        items = [tree[k] for k in keys]
        kind = "dict"
    elif isinstance(tree, (list, tuple)):
        keys, items = (), list(tree)
        kind = "tuple" if isinstance(tree, tuple) else "list"
    else:
        raise TypeError(f"route fields must be tensors, dicts, lists or "
                        f"tuples, got {type(tree).__name__}")
    leaves, children = [], []
    for item in items:
        sub, td = tree_flatten(item)
        leaves += sub
        children.append(td)
    return leaves, TreeDef(kind, keys, children)


def _build(td: TreeDef, it):
    if td.kind == "leaf":
        return next(it)
    items = [_build(c, it) for c in td.children]
    if td.kind == "dict":
        return dict(zip(td.keys, items))
    return tuple(items) if td.kind == "tuple" else items


def tree_unflatten(treedef: TreeDef, leaves):
    # a module-level builder: a recursive closure would be a reference
    # cycle holding the leaves (the routed buffers) until the next garbage
    # collection, not until the caller drops them
    return _build(treedef, iter(leaves))


# ---------------------------------------------------- packed wire format --

def _leaf_row_words(shape, dtype) -> int:
    row_bytes = math.prod(shape[1:]) * torch.empty((), dtype=dtype
                                                   ).element_size()
    return -(-row_bytes // WORD_BYTES)


def packed_row_words(fields) -> int:
    """Wire width of one packed request row in 32-bit lanes: every leaf's
    lanes plus the trailing valid lane (what the transport bills)."""
    leaves, _ = tree_flatten(fields)
    return sum(_leaf_row_words(l.shape, l.dtype) for l in leaves) + 1


def _pack_leaf(x: torch.Tensor) -> torch.Tensor:
    """(A, ...) any dtype -> (A, w) int32 lanes, bit-exact."""
    A = x.shape[0]
    flat = x.reshape(A, math.prod(x.shape[1:]))
    if flat.dtype == torch.bool:
        flat = flat.to(torch.uint8)
    size = flat.element_size()
    if size < WORD_BYTES:
        pad = (-flat.shape[1]) % (WORD_BYTES // size)
        if pad:
            flat = torch.cat([flat, flat.new_zeros((A, pad))], dim=1)
    return flat.contiguous().view(WORD).reshape(
        A, _leaf_row_words(x.shape, x.dtype))


def _unpack_leaf(words: torch.Tensor, shape, dtype) -> torch.Tensor:
    """(B, w) int32 lanes -> (B,) + shape[1:] of dtype (inverse of
    :func:`_pack_leaf`); empty slots unpack to the all-zero pattern."""
    B = words.shape[0]
    carrier = torch.uint8 if dtype == torch.bool else dtype
    flat = words.contiguous().view(carrier)[:, :math.prod(shape[1:])]
    if dtype == torch.bool:
        flat = flat.to(torch.bool)
    return flat.reshape((B,) + tuple(shape[1:]))


def pack_fields(fields, valid: bool = True):
    """Pack a request pytree into one (A, row_words) int32 buffer whose last
    lane is the valid mask (ones).  ``valid=False`` leaves the lane out:
    the scatter kernel appends it as each row lands.
    Returns (packed, treedef, leaf_specs)."""
    leaves, treedef = tree_flatten(fields)
    specs = [(tuple(l.shape), l.dtype) for l in leaves]
    A = leaves[0].shape[0] if leaves else 0
    device = leaves[0].device if leaves else None
    cols = [_pack_leaf(l) for l in leaves]
    if valid:
        cols.append(torch.ones((A, 1), dtype=WORD, device=device))
    elif not cols:
        cols.append(torch.zeros((A, 0), dtype=WORD, device=device))
    return torch.cat(cols, dim=1), treedef, specs


def unpack_fields(buf, treedef, specs):
    """Split a (B, row_words) wire buffer into (fields pytree, valid)."""
    out, col = [], 0
    for shape, dtype in specs:
        w = _leaf_row_words(shape, dtype)
        out.append(_unpack_leaf(buf[:, col:col + w], shape, dtype))
        col += w
    return tree_unflatten(treedef, out), buf[:, col].to(torch.int32)


# ------------------------------------------------------------ planning ---

@dataclass
class RoutePlan:
    """Precomputed slot assignment for one ``dest`` vector.

    slot:     (A,) int32 — dest*cap + rank for kept requests, n*cap
              otherwise.
    keep:     (A,) bool — deliverable and within capacity.
    overflow: (A,) bool — deliverable but beyond capacity (the drops).
    counts:   (n,) int32 — kept requests per bucket, min(bucket size,
              cap): bucket d's kept requests hold its first counts[d]
              slots, which lets the scatter kernel skip any zero fill.
    window:   doorbell-batching cap declared for contention pricing (0 =
              post everything at once); the wire bits do not depend on it.
    """
    n: int
    cap: int
    slot: torch.Tensor
    keep: torch.Tensor
    overflow: torch.Tensor
    counts: torch.Tensor
    window: int = 0

    @property
    def dropped(self) -> torch.Tensor:
        return self.overflow.sum(dtype=torch.int32)


def _check_window(window) -> int:
    window = int(window or 0)
    if window < 0:
        raise ValueError(f"window must be >= 0 (0 = unbounded), "
                         f"got {window}")
    return window


def plan_route(dest, *, n: int, cap: int, window: int = 0,
               impl=None) -> RoutePlan:
    """Stable rank-in-bucket slot assignment for ``dest``: the rank kernel
    on a CUDA tensor, :func:`repro_torch.kernels.ref.rank` on the CPU."""
    slot, keep, overflow, counts = ops.rank(dest, n, cap, impl=impl)
    return RoutePlan(n=n, cap=cap, slot=slot, keep=keep, overflow=overflow,
                     counts=counts, window=_check_window(window))


def _masked_slot(plan: RoutePlan, mask) -> torch.Tensor:
    if mask is None:
        return plan.slot
    return torch.where(mask & plan.keep, plan.slot,
                       torch.full_like(plan.slot, plan.n * plan.cap))


def _invert_plan(plan: RoutePlan, mask) -> torch.Tensor:
    """slot -> request gather index: ``inv[s]`` = the request in wire slot
    ``s``, or A (one past the batch) for an empty slot."""
    slot = _masked_slot(plan, mask)
    A = slot.shape[0]
    S = plan.n * plan.cap
    inv = torch.full((S + 1,), A, dtype=torch.int64, device=slot.device)
    inv[slot.to(torch.int64)] = torch.arange(A, device=slot.device)
    return inv[:S]


# --------------------------------------------------------------- route ---

def route(fields, dest=None, *, n: Optional[int] = None,
          cap: Optional[int] = None, chunks: int = 1,
          exchange: Optional[Callable] = None,
          plan: Optional[RoutePlan] = None, mask=None,
          window: Optional[int] = None, overlap: bool = False,
          impl=None) -> RouteResult:
    """Radix-partition ``fields`` by ``dest`` into (n, cap) buffers and
    (optionally) exchange them as ONE packed buffer.  ``plan=`` reuses a
    slot assignment; ``mask=`` (needs a plan) unsends requests without
    re-ranking.  ``window=`` is a pacing declaration only.

    ``overlap=True`` is the double-buffered pipeline: the plan is inverted
    once and each chunk's buffer is a gather over its own slot range, so
    chunk k+1 packs while chunk k is on the wire.  Same slots, drops and
    bytes as the scatter path."""
    if plan is not None:
        n, cap = plan.n, plan.cap
        if window is None:
            window = plan.window
    elif n is None or cap is None:
        raise ValueError("route needs n= and cap= (or a plan=)")
    _check_window(window)
    if mask is not None and plan is None:
        raise ValueError("mask= only applies to a reused plan=")
    if cap % chunks != 0:
        raise ValueError(f"cap={cap} not divisible by chunks={chunks}")
    if plan is None:
        plan = plan_route(dest, n=n, cap=cap, impl=impl)
        mask = None
    if mask is not None:
        mask = mask.to(torch.bool)
    dropped = (plan.dropped if mask is None else
               (plan.overflow & mask).sum(dtype=torch.int32))
    if overlap:
        rows, treedef, specs = pack_fields(fields)
        inv = _invert_plan(plan, mask)
        padded = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
        if exchange is None:
            sent, sent_valid = unpack_fields(padded[inv], treedef, specs)
            return RouteResult(sent, sent_valid, dropped, sent, sent_valid)
        c = cap // chunks
        w = rows.shape[1]
        inv_c = inv.reshape(n, chunks, c).movedim(1, 0)
        sent_s, recv_s = [], []
        for ic in inv_c:
            sent_c = padded[ic.reshape(n * c)]       # pack chunk (gather)
            sent_s.append(sent_c)
            recv_s.append(exchange(sent_c))          # chunk on the wire

        def restripe(xs):
            return torch.stack(xs).reshape(chunks, n, c, w).movedim(
                0, 1).reshape(n * cap, w)

        sent, sent_valid = unpack_fields(restripe(sent_s), treedef, specs)
        recv, valid = unpack_fields(restripe(recv_s), treedef, specs)
        return RouteResult(recv, valid, dropped, sent, sent_valid)
    rows, treedef, specs = pack_fields(fields, valid=False)
    buf = ops.scatter_rows(rows, plan.slot, n * cap, counts=plan.counts,
                           mask=mask, impl=impl)
    sent, sent_valid = unpack_fields(buf, treedef, specs)
    if exchange is None:
        return RouteResult(sent, sent_valid, dropped, sent, sent_valid)
    recv, valid = unpack_fields(exchange(buf), treedef, specs)
    return RouteResult(recv, valid, dropped, sent, sent_valid)


def chunked_all_to_all(v, group, n: int, cap: int, chunks: int = 1):
    """Paired all-to-all of each shard's (n*cap, ...) buffer among the n
    shards of ``group`` (a :class:`~repro_torch.fabric.transport.
    MeshTransport` inside its ``run``): shard i receives block i of every
    shard's buffer, in source order.  ``chunks > 1`` gives the same
    buffer (the JAX package's scan only pipelines the transfer); it must
    divide cap, as there."""
    if v.shape[0] != n * cap:
        raise ValueError(f"an all-to-all buffer of {v.shape[0]} rows is not "
                         f"n*cap = {n}*{cap}")
    if chunks < 1 or cap % chunks:
        raise ValueError(f"cap={cap} not divisible by chunks={chunks}")
    me = group.shard_index()
    return torch.cat([b[me * cap:(me + 1) * cap]
                      for b in group.gather("all_to_all", v)])
