"""Wrappers of the hand-written grouped scatter-add (``csrc/grouped_agg.cu``).

Replaces the Pallas ``repro.kernels.grouped_agg.grouped_agg``
(``src/repro/kernels/grouped_agg.py:41``) and the jnp scatter-adds the
JAX aggregation operators run in its place.  Three entries share one
templated body a pass:

* :func:`grouped_agg`, the TPU kernel's function: f32 sums per slot;
* :func:`grouped_sum_u32`, the same on u32 words (int32 bit patterns)
  with a wrapping add;
* :func:`grouped_sum_u32_by_key`, which reads u32 keys and computes each
  row's slot in the kernel: ``key % G`` (``segment_sum_by_key``,
  ``preagg_table``) or RDMA-AGG's phase-1 layout of (chunk, owner,
  group) tables.

:func:`plan` picks the kernel's path for a table of S slots: ``shared``
(per-warp copies of the table in shared memory), ``global`` (atomics
into a table in L2) or ``partition`` (rows bucketed by the slot's high
bits into a scratch of 8 B a row, then one shared-memory table a bucket;
a hot bucket is split over blocks, :func:`work_items`).  It is plain
Python, so the CPU tests hold its properties.  All entries take CUDA
tensors only; the plain versions are in :mod:`repro_torch.kernels.ref`
and :mod:`repro_torch.kernels.ops` picks.

Bound: bytes (see the source).  ``launches`` counts the calls that
launched each entry's kernels: ``f32`` for :func:`grouped_agg`, ``u32``
for the two u32 entries (one device body, which reads slots or keys).
Each call has scratch of its own; ``_lock`` covers the library's load,
the device's attributes, the launches and their count, as shards of a
``MeshTransport`` call in from several threads at once.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.radix_partition import _check, _raise_on, _stream

launches = {"f32": 0, "u32": 0}
# the device kernels each entry launches, as the profiler names them
_PASSES = ("agg_kernel", "part_hist", "part_scan", "part_scatter",
           "part_refine", "part_agg")
KERNELS = {"f32": _PASSES, "u32": _PASSES}

THREADS = 512                   # a block of every streaming pass
ROWS_A_BLOCK_PASS = THREADS * 2 * 4   # rows a block takes a loop turn
MAX_COPIES = THREADS // 32      # one table copy a warp at most
SHARED_MAX_BYTES = 200 * 1024   # largest table the shared path takes
PARTITION_MAX_SLOTS = 1 << 28   # partition: at most 16384 buckets of 2^14
ROWS_PER_PART = 1 << 17         # most rows one block of part_agg takes
MIN_BITS, MAX_BITS = 8, 15      # slots a bucket: 1 KB .. 128 KB of table
TWO_PASS_BITS = 14              # with two radix passes: 64 KB tables
MAX_DIGITS_LOG2 = 7             # buckets a radix pass: at most 128
TILE = THREADS * 8              # rows a radix pass stages at a time
SCATTER_SMEM = (3 * 128 + 4) * 4 + TILE * 8   # its shared bytes a block
H100 = (132, 232_448, 233_472)  # SMs, shared bytes a block, an SM
_RESERVED = 1024                # shared bytes the card keeps a block


@dataclass(frozen=True)
class Plan:
    """How the kernel runs one call.  ``grid``: blocks of the streaming
    passes; ``smem``: shared bytes a block of the largest pass claims;
    ``copies``: table copies a block (shared); ``bits``/``buckets``/
    ``rows_per_part``: the partition's buckets of 2^bits slots and the
    most rows a work item takes; ``lo_bits``: 0 for one radix pass over
    at most 128 buckets, else two, the first into super-buckets of
    2^lo_bits buckets; ``batch``: rows a batch (at most two), whose
    first-pass pairs (8 B a row) reuse one scratch."""
    path: str
    grid: int
    smem: int
    copies: int = 1
    bits: int = 0
    buckets: int = 0
    lo_bits: int = 0
    rows_per_part: int = ROWS_PER_PART
    batch: int = 1

    @property
    def supers(self) -> int:
        """Buckets of the first radix pass (the buckets themselves with
        one pass, super-buckets of 2^lo_bits buckets with two)."""
        return -(-self.buckets // (1 << self.lo_bits))

    def bucket_range(self, b: int, num_slots: int) -> tuple:
        """The slots [lo, hi) of bucket b."""
        lo = b << self.bits
        return lo, min(lo + (1 << self.bits), num_slots)


def _blocks_an_sm(smem: int, smem_sm: int) -> int:
    return 2 if 2 * (smem + _RESERVED) <= smem_sm else 1


def _grid(rows: int, per_sm: int, sms: int) -> int:
    need = -(-max(rows, 1) // ROWS_A_BLOCK_PASS)
    return max(1, min(sms * per_sm, need))


def _choose(S: int, rows: int, info) -> str:
    if 4 * S <= min(SHARED_MAX_BYTES, info[1] - _RESERVED):
        return "shared"
    if S > PARTITION_MAX_SLOTS or rows >= 2 ** 31:
        return "global"
    return "partition"


@functools.lru_cache(maxsize=512)
def plan(num_slots: int, rows: int, info=H100, path: str = None) -> Plan:
    """The path for ``rows`` rows into a table of ``num_slots`` u32 or
    f32 slots on a card of ``info`` = (SMs, shared bytes a block may opt
    in to, shared bytes an SM).  ``path`` forces a path (for measuring
    them: ``bench/grouped_paths.py``)."""
    sms, smem_block, smem_sm = info
    S = int(num_slots)
    table = 4 * S
    path = path or _choose(S, rows, info)
    if path == "shared":
        if table > smem_block - _RESERVED:
            raise ValueError(f"a table of {S} slots does not fit shared "
                             "memory")
        two = smem_sm // 2 - _RESERVED
        copies = max(1, min(MAX_COPIES, two // table))
        smem = copies * table
        return Plan("shared", _grid(rows, _blocks_an_sm(smem, smem_sm), sms),
                    smem, copies=copies)
    if path == "global":
        return Plan("global", _grid(rows, 2, sms), 0)
    if path != "partition" or S > PARTITION_MAX_SLOTS or rows >= 2 ** 31:
        raise ValueError(f"no path {path!r} for {S} slots and {rows} rows")
    # one radix pass over at most 128 buckets where tables of up to 2^15
    # slots allow it (S <= 2^22), else two passes into buckets of 2^14
    # slots, whose tables let part_agg run 3 blocks an SM
    bits = max(MIN_BITS, (S - 1).bit_length() - MAX_DIGITS_LOG2)
    bits = bits if bits <= MAX_BITS else TWO_PASS_BITS
    nb = -(-S // (1 << bits))
    nb_log2 = (nb - 1).bit_length()
    lo_bits = 0 if nb_log2 <= MAX_DIGITS_LOG2 else -(-nb_log2 // 2)
    smem = max(4 * min(1 << bits, S), 4 * nb, SCATTER_SMEM)
    # two passes run the rows in two batches, the first pass's pairs one
    # batch at a time: 12 B of scratch a row, below the 16 B a row of the
    # int64 slot arrays the keys entry replaces
    batch = rows if not lo_bits else -(-rows // (2 * TILE)) * TILE
    return Plan("partition",
                _grid(rows, _blocks_an_sm(SCATTER_SMEM, smem_sm), sms), smem,
                bits=bits, buckets=nb, lo_bits=lo_bits, batch=max(batch, 1))


def boundaries(rows: int, info=H100) -> list:
    """Every S at which :func:`plan` changes its path, its blocks an SM or
    its bucket bits between S and S + 1."""
    out = []
    last = None
    cands = {SHARED_MAX_BYTES // 4, PARTITION_MAX_SLOTS,
             (info[2] // 2 - _RESERVED) // 4}
    cands |= {1 << (b + MAX_DIGITS_LOG2)
              for b in range(MIN_BITS, MAX_BITS + 1)}
    cands |= {1 << (TWO_PASS_BITS + b) for b in range(MAX_DIGITS_LOG2, 15)}
    for S in sorted(c for c in cands if c >= 1):
        a, b = plan(S, rows, info), plan(S + 1, rows, info)
        key = lambda p: (p.path, p.bits, p.lo_bits, p.grid)   # noqa: E731
        if key(a) != key(b) and S != last:
            out.append(S)
            last = S
    return out


def work_items(counts, rows_per_part: int = ROWS_PER_PART):
    """part_scan and part_agg's split of the buckets, in numpy: for
    bucket b of ``counts[b]`` rows, max(1, ceil(rows / rows_per_part))
    items of ceil(rows / items) rows.  Returns (bucket, first row, end
    row, split) arrays, rows counted from the first row of bucket 0."""
    counts = np.asarray(counts, dtype=np.int64)
    parts = np.maximum(1, -(-counts // rows_per_part))
    start = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    bucket = np.repeat(np.arange(counts.shape[0]), parts)
    first_item = np.concatenate([[0], np.cumsum(parts)[:-1]])
    part = np.arange(bucket.shape[0]) - first_item[bucket]
    per = -(-counts // parts)
    lo = start[bucket] + part * per[bucket]
    hi = np.minimum(lo + per[bucket], start[bucket] + counts[bucket])
    return bucket, lo, np.maximum(hi, lo), parts[bucket] > 1


def fast_divisor(d: int) -> tuple:
    """(d, m, sh) for the kernel's ``udiv``: floor(x / d) = (t + ((x - t)
    >> 1)) >> sh with t = (m * x) >> 32, for every u32 x and 1 <= d <
    2^31 (Granlund-Montgomery); d == 1 is taken apart (m = 0)."""
    d = int(d)
    if not 1 <= d < 2 ** 31:
        raise ValueError(f"divisor {d} outside [1, 2**31)")
    if d == 1:
        return 1, 0, 0
    ell = (d - 1).bit_length()
    return d, (2 ** 32 * (2 ** ell - d)) // d + 1, ell - 1


def key_slots(groups: int, chunks: int = 1, n: int = 1) -> int:
    """Slots of the keys entry's table: chunks * n * max(groups // n, 1)."""
    return chunks * n * max(groups // n, 1)


_P, _I, _U, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, \
    ctypes.c_longlong


class _Args(ctypes.Structure):
    """The kernel's ``AggArgs``, field for field."""
    _fields_ = [("x", _P), ("vals", _P), ("N", _L), ("S", _I),
                ("kind", _I), ("g_d", _U), ("g_m", _U), ("g_sh", _I),
                ("z_d", _U), ("z_m", _U), ("z_sh", _I), ("n", _I),
                ("chunks", _I), ("clen", _L), ("path", _I), ("copies", _I),
                ("bits", _I), ("lo_bits", _I), ("rows_per_part", _I),
                ("batch", _L), ("grid", _I), ("meta", _P), ("pairs", _P),
                ("tmp", _P), ("out", _P), ("device", _I), ("stream", _P)]


_PATHS = {"shared": 0, "global": 1, "partition": 2}
_lib = None
_info: dict = {}
_lock = threading.Lock()


def _load():
    global _lib
    if _lib is None:
        lib = build.load("grouped_agg")
        lib.grouped_agg_run.argtypes = [ctypes.POINTER(_Args), _I]
        lib.grouped_agg_run.restype = _I
        lib.grouped_agg_device_info.argtypes = [_I, ctypes.POINTER(_I)]
        lib.grouped_agg_device_info.restype = _I
        _lib = lib
    return _lib


def device_info(device) -> tuple:
    """(SMs, shared bytes a block, shared bytes an SM) of a card, read
    once."""
    di = torch.device(device).index
    di = torch.cuda.current_device() if di is None else di
    with _lock:
        if di not in _info:
            buf = (_I * 3)()
            _raise_on(_load().grouped_agg_device_info(di, buf),
                      "grouped_agg_device_info")
            _info[di] = tuple(buf)
        return _info[di]


def _run(dtype: int, x, vals, S: int, what: str, p, kind: int = 0,
         g=(1, 0, 0), z=(1, 0, 0), n: int = 1, chunks: int = 1):
    di = x.get_device()
    N = x.shape[0]
    p = p or plan(S, N, _info.get(di) or device_info(x.device))
    out = torch.empty((S,), dtype=torch.float32 if dtype == 0 else
                      torch.int32, device=x.device)
    if N == 0:
        return out.zero_()
    meta = pairs = tmp = None
    if p.path == "partition":
        # the kernel's Meta, then (N,) pairs, then (N,) pairs of the first
        # of two radix passes
        head = -(-(8 * p.buckets + 774) // 4) * 4     # the kernel's Meta
        first = 2 * min(N, p.batch) if p.lo_bits else 0
        scratch = torch.empty((head + 2 * N + first,), dtype=torch.int32,
                              device=x.device)
        meta = scratch.data_ptr()
        pairs = meta + 4 * head                    # (N,) pairs
        tmp = pairs + 8 * N if p.lo_bits else None   # one batch's pairs
    a = _Args(x.data_ptr(), vals.data_ptr(), N, S, kind, g[0], g[1], g[2],
              z[0], z[1], z[2], n, chunks, N // chunks, _PATHS[p.path],
              p.copies, p.bits, p.lo_bits, p.rows_per_part, p.batch, p.grid,
              meta,
              pairs, tmp, out.data_ptr(), di, _stream(di))
    with _lock:
        _raise_on((_lib or _load()).grouped_agg_run(ctypes.byref(a), dtype),
                  f"grouped_agg ({p.path}) launch")
        launches[what] += 1
    return out


def _check_rows(x, name, vals, dtype):
    _check(x, name, torch.int32, 1)
    _check(vals, "vals", dtype, 1, x.device)
    if vals.shape[0] != x.shape[0]:
        raise ValueError(f"vals has {vals.shape[0]} rows, {name} has "
                         f"{x.shape[0]}")


def _slots(num_slots) -> int:
    S = int(num_slots)
    if not 1 <= S < 2 ** 31:
        raise ValueError(f"num_slots={S} outside [1, 2**31)")
    return S


def grouped_agg(slot: torch.Tensor, vals: torch.Tensor, num_slots: int, *,
                plan: Plan = None) -> torch.Tensor:
    """(num_slots,) f32 per-slot sums of ``vals`` (N,) f32 by ``slot``
    (N,) int32.  Rows whose slot lies outside [0, num_slots) are skipped.
    The order of the f32 additions changes from run to run.  ``plan``
    overrides :func:`plan`'s choice (for measuring the paths)."""
    _check_rows(slot, "slot", vals, torch.float32)
    return _run(0, slot, vals, _slots(num_slots), "f32", plan)


def grouped_sum_u32(slot: torch.Tensor, vals: torch.Tensor,
                    num_slots: int, *, plan: Plan = None) -> torch.Tensor:
    """(num_slots,) u32 per-slot sums mod 2**32 (int32 bit patterns) of the
    u32 words ``vals`` (N,) int32 by ``slot`` (N,) int32; exact in any
    order.  Rows whose slot lies outside [0, num_slots) are skipped."""
    _check_rows(slot, "slot", vals, torch.int32)
    return _run(1, slot, vals, _slots(num_slots), "u32", plan)


def grouped_sum_u32_by_key(keys: torch.Tensor, vals: torch.Tensor,
                           groups: int, *, chunks: int = 1, n: int = 1,
                           plan: Plan = None) -> torch.Tensor:
    """u32 sums mod 2**32 of ``vals`` by a slot the kernel computes from
    the u32 ``keys`` (N,) (int32 bit patterns): ``s = key % groups``;
    with ``chunks = n = 1`` the table is (groups,) and the slot is s,
    else it is RDMA-AGG's (chunks * n * gsz,) phase-1 table with ``gsz =
    max(groups // n, 1)`` and slot ``(c * n + min(s // gsz, n - 1)) * gsz
    + s % gsz`` for a row of chunk c (N // chunks rows a chunk)."""
    _check_rows(keys, "keys", vals, torch.int32)
    G, chunks, n = int(groups), int(chunks), int(n)
    if chunks < 1 or n < 1 or keys.shape[0] % chunks:
        raise ValueError(f"{keys.shape[0]} rows do not split into "
                         f"{chunks} chunks, or n={n} < 1")
    S = _slots(key_slots(G, chunks, n))
    return _run(1, keys, vals, S, "u32", plan, kind=1, g=fast_divisor(G),
                z=fast_divisor(max(G // n, 1)), n=n, chunks=chunks)
