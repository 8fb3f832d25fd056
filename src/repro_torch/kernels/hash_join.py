"""Wrapper of the hand-written partitioned hash join (``csrc/hash_join.cu``).

Replaces no TPU kernel: the JAX package's local join is ``jnp.sort`` and
``searchsorted`` under XLA (``src/repro/core/shuffle.py``: ``local_join``
and ``join_agg``).  :func:`join_sum` is that join and its aggregate in
one call: the u32 sum over S's rows of ``rv[match] * sv`` mod 2**32, R's
keys unique, a ``MISS`` key (0xFFFFFFFF) no row on either side.  CUDA
tensors only; the plain version (the sort-probe) is
:func:`repro_torch.kernels.ref.join_sum` and :mod:`repro_torch.kernels.ops`
picks.

:func:`plan` sizes a call from |R| (slots, ``MISS`` included) alone, so
nothing is read back from the card: 2**bits hash partitions, so that an
average partition fills at most half of a shared-memory table of at most
:data:`TABLE_MAX` entries, one radix pass into at most 256 of them, two
above that; the table by the same average.  It is plain Python, so the
CPU tests hold it.  A key's partition is the top bits of ``key *
HASH_MUL`` mod 2**32.

Bound: bytes (see the source).  ``launches["hash_join"]`` counts the
calls that launched the join's kernels.  Each call allocates its own
scratch: shards of a ``MeshTransport`` call in from several threads at
once.  ``_lock`` covers the library's load, the device's attributes, the
launch and its count.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass

import torch

from repro_torch.kernels import build
from repro_torch.kernels.radix_partition import _check, _raise_on, _stream

launches = {"hash_join": 0}
# the device kernels the entry launches, as the profiler names them
KERNELS = {"hash_join": ("join_hist", "join_scan", "join_scatter",
                         "join_refine", "join_probe")}

HASH_MUL = 0x9E3779B1       # the kernel's multiplicative hash: key * this
TABLE_MAX = 1 << 14         # entries (u32 key + u32 value): 128 KB
MIN_TABLE = 64
MAX_BITS = 15               # 2^15 partitions: a 128 KB shared histogram
PASS_BITS = 8               # digits of a radix pass: at most 2^8
MAX_ROWS = 2 ** 31 - TABLE_MAX   # int32 row positions, chunk ends included
H100 = (132, 232_448, 233_472)   # SMs, shared bytes a block, an SM
_RESERVED = 1024            # shared bytes the card keeps a block
HIST_THREADS = PROBE_THREADS = 1024   # threads a block, as the radix passes'


@dataclass(frozen=True)
class Plan:
    """One call: ``bits`` (2**bits partitions), ``lo_bits`` (0 for one
    radix pass, else the second pass's digits), ``table`` (entries of the
    probe's shared table), and the blocks of the histogram (a relation),
    of the radix passes and of the probe."""
    bits: int
    lo_bits: int
    table: int
    grid_hist: int
    grid_pass: int
    grid_probe: int

    @property
    def parts(self) -> int:
        return 1 << self.bits


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def _per_sm(smem: int, threads: int, smem_sm: int) -> int:
    return max(1, min(2048 // threads, smem_sm // (smem + _RESERVED)))


@functools.lru_cache(maxsize=256)
def plan(r_rows: int, info=H100) -> Plan:
    """The plan for an R of ``r_rows`` slots on a card of ``info`` = (SMs,
    shared bytes a block may opt in to, shared bytes an SM)."""
    sms, smem_block, smem_sm = info
    r_rows = max(int(r_rows), 1)
    parts = _pow2_at_least(-(-r_rows // (TABLE_MAX // 2)))
    bits = min(MAX_BITS, max(1, parts.bit_length() - 1))
    avg = -(-r_rows // (1 << bits))
    table = min(TABLE_MAX, max(MIN_TABLE, _pow2_at_least(2 * avg)))
    hist_smem = 4 * (1 << bits)
    probe_smem = 4 * (2 * table + 32)
    if max(hist_smem, probe_smem) > smem_block:
        raise ValueError(f"a table of {table} entries or {1 << bits} "
                         "partitions does not fit shared memory")
    return Plan(bits=bits, lo_bits=0 if bits <= PASS_BITS else PASS_BITS,
                table=table,
                grid_hist=sms * _per_sm(hist_smem, HIST_THREADS, smem_sm),
                grid_pass=sms,          # 64 registers a thread: one an SM
                grid_probe=sms * _per_sm(probe_smem, PROBE_THREADS, smem_sm))


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


class _Args(ctypes.Structure):
    """The kernel's ``JoinArgs``, field for field."""
    _fields_ = [("rk", _P), ("rv", _P), ("nr", _L), ("sk", _P), ("sv", _P),
                ("ns", _L), ("bits", _I), ("lo_bits", _I), ("table", _I),
                ("grid_hist", _I), ("grid_pass", _I), ("grid_probe", _I),
                ("meta", _P), ("pairs_r", _P), ("pairs_s", _P), ("tmp", _P),
                ("out", _P), ("device", _I), ("stream", _P)]


_lib = None
_info: dict = {}
_lock = threading.Lock()


def _load():
    global _lib
    if _lib is None:
        lib = build.load("hash_join")
        lib.hash_join_run.argtypes = [ctypes.POINTER(_Args)]
        lib.hash_join_run.restype = _I
        lib.hash_join_device_info.argtypes = [_I, ctypes.POINTER(_I)]
        lib.hash_join_device_info.restype = _I
        lib.hash_join_meta_ints.argtypes = [_I]
        lib.hash_join_meta_ints.restype = _I
        _lib = lib
    return _lib


def device_info(di: int) -> tuple:
    """(SMs, shared bytes a block, shared bytes an SM) of card ``di``, read
    once."""
    with _lock:
        if di not in _info:
            buf = (_I * 3)()
            _raise_on(_load().hash_join_device_info(di, buf),
                      "hash_join_device_info")
            _info[di] = tuple(buf)
        return _info[di]


def join_sum(rk: torch.Tensor, rv: torch.Tensor, sk: torch.Tensor,
             sv: torch.Tensor) -> torch.Tensor:
    """The u32 sum mod 2**32 (a 0-dim int32 bit pattern) over S's rows
    whose key is in R of ``rv[match] * sv``.  R's keys (``rk``) are
    unique; a ``MISS`` key is no row.  All four int32, 1-D, contiguous, on
    one CUDA device; ``rv`` as long as ``rk``, ``sv`` as ``sk``."""
    _check(rk, "rk", torch.int32, 1)
    for name, t in (("rv", rv), ("sk", sk), ("sv", sv)):
        _check(t, name, torch.int32, 1, rk.device)
    nr, ns = rk.shape[0], sk.shape[0]
    if rv.shape[0] != nr or sv.shape[0] != ns:
        raise ValueError(f"keys and values differ in length: R {nr} and "
                         f"{rv.shape[0]}, S {ns} and {sv.shape[0]}")
    if max(nr, ns) > MAX_ROWS:
        raise ValueError(f"{max(nr, ns)} rows: at most {MAX_ROWS}")
    if nr == 0 or ns == 0:
        return torch.zeros((), dtype=torch.int32, device=rk.device)
    di = rk.get_device()
    p = plan(nr, _info.get(di) or device_info(di))
    with _lock:
        lib = _lib or _load()
        meta_ints = lib.hash_join_meta_ints(p.bits)
    tmp = max(nr, ns) if p.lo_bits else 0
    # (nr,) and (ns,) pairs of (hash, value), then the first pass's pairs
    pairs = torch.empty((2 * (nr + ns + tmp),), dtype=torch.int32,
                        device=rk.device)
    meta = torch.empty((meta_ints,), dtype=torch.int32, device=rk.device)
    out = torch.empty((), dtype=torch.int32, device=rk.device)
    base = pairs.data_ptr()
    a = _Args(rk.data_ptr(), rv.data_ptr(), nr, sk.data_ptr(), sv.data_ptr(),
              ns, p.bits, p.lo_bits, p.table, p.grid_hist, p.grid_pass,
              p.grid_probe, meta.data_ptr(), base, base + 8 * nr,
              base + 8 * (nr + ns) if tmp else None, out.data_ptr(), di,
              _stream(di))
    with _lock:
        _raise_on(lib.hash_join_run(ctypes.byref(a)), "hash_join launch")
        launches["hash_join"] += 1
    return out
