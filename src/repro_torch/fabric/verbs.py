"""One-sided verbs over named regions (paper §3.1.4), in PyTorch.

The port of ``repro.fabric.verbs``: READ / WRITE / CAS / FETCH_ADD with the
same index and priority rules, and the :class:`NamPool` that names
regions.  Shared semantics:

  * indices are row indices into a region tensor; a **negative index is a
    no-op** (READ returns zeros, WRITE/CAS/FETCH_ADD drop the request);
    past the end, each verb keeps the JAX verb's rule (READ fills, WRITE
    drops, CAS and FETCH_ADD compare against the last word and drop the
    update);
  * concurrent requests to one word are arbitrated **by priority** (lower
    wins; default = request order) — a serial schedule;
  * 32-bit words are int32 bit patterns (:mod:`repro_torch._bits`).

Unlike JAX, WRITE, CAS and FETCH_ADD update the region tensor **in place**
and return that same tensor, so a commit never copies a region.  Callers
that need the old state clone it first.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch._bits import M32, put_rows, to_i32, u32
from repro_torch.kernels import ops
from repro_torch.kernels.ref import lex_winner as _lex_winner

__all__ = ["Region", "TieredRegion", "NamPool", "Completion", "read",
           "write", "cas", "fetch_add", "_lex_winner"]


@dataclass(frozen=True)
class Region:
    name: str
    shape: tuple
    dtype: object
    logical_axes: tuple


@dataclass(frozen=True)
class TieredRegion:
    """Descriptor of a two-tier block region: a bounded LOCAL hot tier in
    front of a disaggregated cold region.  Only the cold tier is a NAM
    region (``cold``: fixed-size u32 blocks, reached by one-sided READ and
    WRITE); the hot tier is client memory of ``hot_blocks`` rows that
    never crosses the wire.  :class:`repro_torch.fabric.tier.TieredStore`
    keeps the residency."""

    name: str
    n_blocks: int
    block_words: int
    hot_blocks: int
    cold: Region

    @property
    def hot_fraction(self) -> float:
        return self.hot_blocks / self.n_blocks


@dataclass
class NamPool:
    """Factory for named regions: descriptors of the tensors a protocol
    keeps (placement is the transport's business)."""

    regions: dict = field(default_factory=dict)

    def alloc(self, name: str, shape, dtype, logical_axes=None) -> Region:
        if name in self.regions:
            raise KeyError(f"region {name!r} exists")
        la = tuple(logical_axes) if logical_axes else (None,) * len(shape)
        r = Region(name, tuple(shape), dtype, la)
        self.regions[name] = r
        return r

    def alloc_tiered(self, name: str, n_blocks: int, block_words: int, *,
                     hot_blocks: int) -> TieredRegion:
        """Allocate a two-tier block region: the cold ``(n_blocks,
        block_words)`` u32 region in the pool, and a bound of
        ``hot_blocks`` local rows in front of it, clamped to [1, n_blocks]
        (1: the all-cold staging buffer; n_blocks: the all-local
        baseline)."""
        n_blocks = int(n_blocks)
        block_words = int(block_words)
        if n_blocks < 1 or block_words < 1:
            raise ValueError("alloc_tiered needs n_blocks >= 1 and "
                             "block_words >= 1")
        hot_blocks = max(1, min(int(hot_blocks), n_blocks))
        cold = self.alloc(name, (n_blocks, block_words), torch.int32)
        return TieredRegion(name=name, n_blocks=n_blocks,
                            block_words=block_words, hot_blocks=hot_blocks,
                            cold=cold)

    def zeros(self, device) -> dict:
        return {n: torch.zeros(r.shape, dtype=r.dtype, device=device)
                for n, r in self.regions.items()}

    def specs(self) -> dict:
        """(shape, dtype) of every region by name (JAX's
        ``ShapeDtypeStruct``s)."""
        return {n: (r.shape, r.dtype) for n, r in self.regions.items()}

    def shardings(self, policy) -> dict:
        """Every region's ``NamedSharding`` under ``policy``, from its
        logical axes."""
        return {n: policy.sharding(r.logical_axes)
                for n, r in self.regions.items()}


# -------------------------------------------------------- completions ----


class Completion:
    """Completion token of an async verb: issue -> overlap -> ``wait()``.

    ``wait()`` returns the verb's result and fires, exactly once, the
    deferred ordering edge the verb withheld at issue (an attached
    recorder's completion fence; nothing without one).  The value is
    computed at issue, on the device's stream, so an async verb changes
    the recorded schedule, never the bits.  ``wait()`` is idempotent;
    ``done`` tells whether it has fired."""

    __slots__ = ("_value", "_on_wait", "_done")

    def __init__(self, value, on_wait=None):
        self._value = value
        self._on_wait = on_wait
        self._done = False

    @property
    def done(self) -> bool:
        return self._done

    def wait(self):
        if not self._done:
            self._done = True
            if self._on_wait is not None:
                self._on_wait()
        return self._value


# ------------------------------------------------------------- verbs -----

def _fill_value(dtype):
    """What JAX's ``take`` puts in rows past the end: NaN for floats, True
    for bool, the largest value for unsigned ints and the smallest for
    signed ones — except int32, which carries u32 words here, so it gets
    the u32 fill 0xFFFFFFFF (-1)."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    if dtype == torch.int32:
        return -1
    info = torch.iinfo(dtype)
    return info.max if info.min == 0 else info.min


def _rows(mask, out):
    return mask.reshape(mask.shape + (1,) * (out.dim() - mask.dim()))


def read(region_arr, idx):
    """One-sided READ of rows ``idx`` (any shape).  Negative -> zeros; past
    the end -> the fill of :func:`_fill_value`."""
    R = region_arr.shape[0]
    idx = idx.to(torch.int64)
    out = region_arr[idx.clamp(0, R - 1)]
    out = out.masked_fill(_rows(idx >= R, out), _fill_value(out.dtype))
    return out * _rows(idx >= 0, out).to(out.dtype)


def write(region_arr, idx, values):
    """One-sided WRITE of rows, in place; indices outside [0, R) dropped."""
    keep = (idx >= 0) & (idx < region_arr.shape[0])
    return put_rows(region_arr, idx, values, keep)


def cas(words, idx, expected, new, priority=None, *, impl=None):
    """Multi-request compare-and-swap with deterministic arbitration.

    words: (R,) int32 lock|CID words, updated in place.
    idx/expected/new: (A,) requests; idx may repeat (conflicts).
    priority: (A,) int32, lower wins (default: request order).
    Returns (success (A,) bool, words).

    Sequential execution in priority order: among the requests whose
    ``expected`` equals the original word, the first in (priority,
    arrival) order wins and installs ``new``.  One pass is exact for lock
    words, where ``new`` sets the lock bit that no ``expected`` has.  On a
    CUDA tensor the arbitration runs the hand-written kernel
    (``kernels/csrc/cas_lock.cu``)."""
    A = idx.shape[0]
    if priority is None:
        priority = torch.arange(A, dtype=torch.int32, device=idx.device)
    ok = ops.cas(words, idx, expected, new, priority, impl=impl)
    return ok, words


def fetch_add(words, idx, delta, priority=None):
    """Multi-request atomic FETCH_ADD with the arbitration of :func:`cas`,
    in place.

    words: (R,) int32 counter words (u32 arithmetic, wrapping at 2**32).
    idx/delta: (A,) requests; idx may repeat.
    Returns (fetched (A,) int32, words).

    Request i fetches the word after every request before it in (priority,
    arrival) order to the same word has added its delta.  Negative idx
    fetches 0 and adds nothing; idx >= R fetches from the last word and
    adds nothing (the JAX verb's clamped gather and dropped scatter).  The
    exclusive prefix is a stable sort by (idx, priority, arrival) and a
    segmented cumsum."""
    A = idx.shape[0]
    R = words.shape[0]
    dev = idx.device
    idx = idx.to(torch.int64)
    if priority is None:
        priority = torch.arange(A, dtype=torch.int32, device=dev)
    valid = idx >= 0
    d = u32(delta.to(torch.int32))
    d_eff = torch.where(valid, d, 0)
    by_prio = torch.sort(priority.to(torch.int32), stable=True).indices
    order = by_prio[torch.sort(idx[by_prio], stable=True).indices]
    ds = d_eff[order]
    excl = torch.cumsum(ds, 0) - ds
    ids = idx[order]
    pos = torch.arange(A, device=dev)
    start = torch.ones((A,), dtype=torch.bool, device=dev)
    start[1:] = ids[1:] != ids[:-1]
    first = torch.cummax(torch.where(start, pos, 0), 0).values
    prefix = torch.empty_like(excl)
    prefix[order] = excl - excl[first]
    safe = idx.clamp(0, R - 1)
    fetched = torch.where(valid, u32(words[safe]) + prefix, 0)
    add = torch.zeros((R,), dtype=torch.int64, device=dev)
    add.index_add_(0, safe, torch.where(valid & (idx < R), d, 0))
    words.copy_(to_i32((u32(words) + add) & M32))
    return to_i32(fetched), words
