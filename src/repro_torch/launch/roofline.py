"""The roofline of one eager step (the port's counterpart of
``repro.launch.roofline``).

The JAX package parses XLA's compiled, partitioned HLO.  PyTorch runs
eagerly, so the port counts the step as it runs: a :class:`StepCounter`
records every aten op the step dispatches (a ``TorchDispatchMode`` on
each thread that runs part of the step), on any device, the meta device
included (``launch/dryrun.py`` runs every cell there, on shapes alone).

  - **FLOPs**: 2*M*N*K for every product (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``, ``mv``, ``addmv``, ``dot``; ``einsum``, ``matmul`` and
    ``linear`` are decomposed into them first), no elementwise work: the
    count of JAX's ``HloModule.flops``.  Convolutions are counted apart
    (``conv_flops``) so that the dots-only total stays comparable.
  - **HBM bytes**: the operands and outputs of every op, which is what
    eager PyTorch streams (each eager op is a top-level op in JAX's
    terms).  Views, ``empty`` and metadata ops are free; a gather or an
    in-place scatter moves its rows and indices, not the whole table
    (JAX's rule for slice-type ops); ``copy_`` reads its source and writes
    its destination; ``fill_`` and ``zero_`` write.
  - **Kernel regions** (:func:`region`): the wrappers of the hand-written
    kernels (``kernels/ops.py``: ``flash_attention``, ``ssd_scan``,
    ``rank``, ``scatter_rows``) mark their call through the hook of
    ``kernels/_region.py``, which this module installs; without an active
    counter a region reckons nothing.  Inside a region the
    plain version's ops count as usual in the totals above (JAX's
    counterpart counts the same plain ops).  The **kernelized** totals
    (``flops_k``, ``bytes_k``) count a region by its inputs and outputs
    once, with its own FLOPs (causal flash: the unmasked half), and
    nothing inside it: the counterpart of JAX's ``memory_s_kernelized``.
    On the card a kernel is a ``ctypes`` call that no dispatch mode sees,
    so the region credits itself to the counter; the card's kernelized
    count equals the meta device's.
  - **Shard bodies**: ``launch/mesh.py``'s ``shard_map`` enters the
    caller's counter in every shard thread (a dispatch mode is
    thread-local), and each shard's ops are credited to that shard.  On
    a meta mesh every shard does the same work, and one body, shard 0's,
    stands for all of them (``stands_for``).
  - **Collectives**: ``Mesh.all_gather``, ``psum`` and ``all_to_all``
    record their bytes per shard under JAX's ring model, kind by kind
    (``all-gather`` b(n-1)/n of the output, ``all-reduce`` 2b(n-1)/n,
    ``all-to-all`` b(n-1)/n).  On one card they are HBM copies; the
    collective term models the NVLink fabric of a real n-GPU node
    (``costmodel.GpuSpec.link_bw``).
  - **Peak live bytes**: every storage an op makes is tracked until it is
    freed (a finalizer on the storage); the peak is the step's above its
    arguments, and its kernelized twin leaves out what a region made
    inside itself but its outputs.

**Per chip** is an ideal partition, not XLA's: the ops outside
``shard_map`` run whole in the port, so they are credited as an even
split over ``n_chips``; each shard body's ops are that shard's own, and
the busiest shard is taken.  XLA's partitioner makes other choices (its
per-chip dots on a small mesh are not the even split), which nothing in
an eager step can reproduce.

:func:`analyze` turns a count into JAX's row: ``compute_s``,
``memory_s``, ``collective_s``, ``dominant``, ``bound_s``, collective
bytes by kind, ``model_flops_per_chip``, ``useful_flop_ratio``,
``roofline_fraction``, ``memory_s_kernelized``,
``roofline_fraction_kernelized`` and ``memory_breakdown``; the keys that
name HLO in JAX's take the port's words (``step_flops_per_chip``,
``step_bytes_per_chip``).
"""
from __future__ import annotations

import math
import threading
import weakref
from collections import defaultdict
from typing import Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

from repro_torch.kernels import _region
from repro_torch.sharding.policy import P

aten = torch.ops.aten
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")

# ------------------------------------------------------------- formulas --


def _mm(a, b, *_, **__):
    return 2 * a.shape[0] * a.shape[1] * b.shape[1]


def _addmm(bias, a, b, *_, **__):
    return _mm(a, b)


def _bmm(a, b, *_, **__):
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _baddbmm(bias, a, b, *_, **__):
    return _bmm(a, b)


def _mv(a, v, *_, **__):
    return 2 * a.shape[0] * a.shape[1]


def _addmv(bias, a, v, *_, **__):
    return _mv(a, v)


def _dot(a, b, *_, **__):
    return 2 * a.shape[0]


DOTS = {aten.mm: _mm, aten.addmm: _addmm, aten.bmm: _bmm,
        aten.baddbmm: _baddbmm, aten.mv: _mv, aten.addmv: _addmv,
        aten.dot: _dot}
CONVS = (aten.convolution,)
FREE = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
        aten.new_empty_strided, aten.detach, aten.alias, aten.lift_fresh,
        aten.sym_size, aten.sym_stride, aten.sym_numel,
        aten.sym_storage_offset, aten._local_scalar_dense,
        aten.is_same_size, aten.resize_, aten._unsafe_view}
ALIASING = {aten._unsafe_view, aten.alias, aten.detach, aten.lift_fresh}
GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding}
PUTS = {aten.index_put_, aten._index_put_impl_}
SCATTERS = PUTS | {aten.index_copy_, aten.index_add_, aten.scatter_,
                   aten.scatter_add_, aten.scatter_reduce_}
WRITES = {aten.fill_, aten.zero_}


def attention_flops(B: int, S: int, T: int, H: int, D: int, Dv: int,
                    causal: bool) -> int:
    """Operations of attention: 2 (D + Dv) H per (query, key) pair, every
    pair when non-causal, the S (S + 1) / 2 unmasked ones when causal
    (T == S)."""
    pairs = S * (S + 1) // 2 if causal else S * T
    return 2 * B * H * (D + Dv) * pairs


def ssd_flops(B: int, S: int, H: int, P: int, N: int,
              L: Optional[int] = 256) -> int:
    """Operations of the chunked SSD at chunk L (the JAX model's form; at
    most S): per chunk C B^T (2 L^2 N), and per head the causal
    intra-chunk product (L(L+1) P), the inter-chunk read of the state and
    its update (2 L N P each)."""
    L = min(L, S)
    chunks = -(-S // L)
    return B * chunks * (2 * L * L * N + H * (L * (L + 1) * P
                                              + 4 * L * N * P))


def ring_bytes(kind: str, nbytes: float, n: int) -> float:
    """Bytes over one device's links for a collective among n devices
    (JAX's ring model): ``nbytes`` is the output of an all-gather, the
    summed tensor of an all-reduce, the scattered output of a
    reduce-scatter, the buffer of an all-to-all."""
    if n <= 1:
        return 0.0
    if kind == "all-gather":
        return nbytes * (n - 1) / n
    if kind == "all-reduce":
        return 2 * nbytes * (n - 1) / n
    if kind == "reduce-scatter":
        return nbytes * (n - 1)
    if kind == "all-to-all":
        return nbytes * (n - 1) / n
    raise ValueError(f"unknown collective {kind!r}")


def nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    """The tensors of nested lists, tuples and dicts."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


_OP_KIND: dict = {}      # func -> (is a view, makes storage, composite)


def _kind(func) -> tuple:
    """(the op is a view, its outputs are new storages (not views, not
    written in place, not ``_unsafe_view``), it decomposes into other aten
    ops (a ``CompositeImplicitAutograd`` kernel)), cached per op."""
    k = _OP_KIND.get(func)
    if k is None:
        rets = func._schema.returns
        view = bool(rets) and all(r.alias_info is not None
                                  and not r.alias_info.is_write
                                  for r in rets)
        fresh = func._overloadpacket not in ALIASING and not any(
            r.alias_info is not None for r in rets)
        composite = func._overloadpacket not in DOTS and \
            torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
        k = _OP_KIND[func] = (view, fresh, composite)
    return k


def _is_view(func) -> bool:
    return _kind(func)[0]


def op_bytes(func, args, kwargs, out) -> int:
    """HBM bytes an eager op moves (see the module docstring)."""
    packet = func._overloadpacket
    if packet in FREE or _is_view(func):
        return 0
    if packet in GATHERS:
        idx = [t for t in _tensors((args[1:], kwargs))
               if not t.is_floating_point()]
        return 2 * sum(map(nbytes, _tensors(out))) + sum(map(nbytes, idx))
    if packet in SCATTERS:          # (self, indices, values) or
        idx, vals = ((args[1], args[2]) if packet in PUTS    # (self, dim,
                     else (args[2], args[3:4]))              # index, src)
        return (2 * sum(map(nbytes, _tensors(vals)))
                + sum(map(nbytes, _tensors(idx))))
    if packet is aten.copy_:
        return nbytes(args[0]) + nbytes(args[1])
    if packet in WRITES:
        return nbytes(args[0])
    return (sum(map(nbytes, _tensors((args, kwargs))))
            + sum(map(nbytes, _tensors(out))))


# ---------------------------------------------------------------- tally --

class Tally:
    """One scope's counts: the whole step outside shard bodies, or one
    shard body."""

    def __init__(self):
        self.flops = 0.0          # dots, every op (JAX-comparable)
        self.conv_flops = 0.0
        self.bytes = 0.0          # every op (JAX-comparable)
        self.flops_k = 0.0        # kernelized: regions by their own count
        self.bytes_k = 0.0
        self.flops_by_op = defaultdict(float)
        self.bytes_by_op = defaultdict(float)     # kernelized breakdown
        self.regions = defaultdict(lambda: [0, 0.0, 0.0])  # calls, F, B
        self.collectives = dict.fromkeys(KINDS, 0.0)

    def as_dict(self) -> dict:
        return {"flops": self.flops, "conv_flops": self.conv_flops,
                "bytes": self.bytes, "flops_k": self.flops_k,
                "bytes_k": self.bytes_k,
                "collectives": dict(self.collectives),
                "regions": {k: list(v) for k, v in self.regions.items()}}


# -------------------------------------------------------------- counter --

_entered = 0                      # counters entered anywhere (fast path)
_entered_lock = threading.Lock()


class _Mode(TorchDispatchMode):
    """One thread's dispatch mode, forwarding every op to its counter."""

    def __init__(self, counter: "StepCounter"):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.prim.device.default:
            return func(*args, **kwargs)
        if _kind(func)[2]:
            with self:            # composites (einsum, reshape, to, ...)
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self.counter._record(func, args, kwargs, out)
        return out


class StepCounter:
    """Counts the ops of everything run inside ``with StepCounter() as c``
    on this thread, and in the shard threads of any ``shard_map`` run
    from it.  Read it with :meth:`per_chip` or :func:`analyze`."""

    def __init__(self):
        self.tallies: dict = defaultdict(Tally)   # None: outside; i: shard
        self.stands_for: dict = {}    # shard -> shards its count stands for
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._storages: dict = {}     # storage key -> [bytes, plain, kern]
        self.live = self.live_k = 0
        self.peak_live = self.peak_live_k = 0
        self.param_gathers = dict.fromkeys(("all-gather", "reduce-scatter"),
                                           0.0)   # per chip, set by dryrun
        self._modes: list = []

    # ----------------------------------------------------------- scope ---

    def __enter__(self):
        global _entered
        mode = _Mode(self)
        self._modes.append(mode)
        with _entered_lock:
            _entered += 1
        mode.__enter__()
        return self

    def __exit__(self, *exc):
        global _entered
        self._modes.pop().__exit__(*exc)
        with _entered_lock:
            _entered -= 1
        return False

    def _shard(self):
        return getattr(self._tls, "shard", None)

    def _depth(self) -> int:
        return getattr(self._tls, "depth", 0)

    def _tally(self) -> Tally:
        return self.tallies[self._shard()]

    # ----------------------------------------------------------- record ---

    def _record(self, func, args, kwargs, out):
        packet = func._overloadpacket
        inside = self._depth() > 0
        nb = op_bytes(func, args, kwargs, out)
        fl = DOTS[packet](*args, **kwargs) if packet in DOTS else 0
        with self._lock:
            t = self._tally()
            t.flops += fl
            t.bytes += nb
            if packet in CONVS:
                t.conv_flops += _conv_flops(args, out)
            if not inside:
                t.flops_k += fl
                t.bytes_k += nb
                name = str(packet)
                t.bytes_by_op[name] += nb
                if fl:
                    t.flops_by_op[name] += fl
        if _kind(func)[1]:
            for o in _tensors(out):
                self._track(o, kernelized=not inside)

    def _track(self, t, kernelized: bool):
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        with self._lock:
            rec = self._storages.get(key)
            if rec is None:
                rec = self._storages[key] = [st.nbytes(), False, False]
                weakref.finalize(st, self._free, key)
            if not rec[1]:
                rec[1] = True
                self.live += rec[0]
                self.peak_live = max(self.peak_live, self.live)
            if kernelized and not rec[2]:
                rec[2] = True
                self.live_k += rec[0]
                self.peak_live_k = max(self.peak_live_k, self.live_k)

    def _free(self, key):
        with self._lock:
            rec = self._storages.pop(key, None)
            if rec is None:
                return
            self.live -= rec[0] if rec[1] else 0
            self.live_k -= rec[0] if rec[2] else 0

    def _credit(self, name: str, flops: float, tensors):
        nb = sum(nbytes(x) for x in tensors)
        with self._lock:
            t = self._tally()
            t.flops_k += flops
            t.bytes_k += nb
            t.bytes_by_op[f"region:{name}"] += nb
            if flops:
                t.flops_by_op[f"region:{name}"] += flops
            r = t.regions[name]
            r[0] += 1
            r[1] += flops
            r[2] += nb

    def collective(self, kind: str, nbytes: float, n: int):
        with self._lock:
            self._tally().collectives[kind] += ring_bytes(kind, nbytes, n)

    # ------------------------------------------------------------ read ---

    @property
    def shards(self) -> list:
        return sorted(k for k in self.tallies if k is not None)

    def per_chip(self, n_chips: int) -> dict:
        """Per-chip counts: the ops outside shard bodies split evenly over
        ``n_chips``, plus the busiest shard's (each field's largest)."""
        out = self.tallies.get(None) or Tally()
        shards = [self.tallies[k] for k in self.shards]

        def field(get):
            mx = max((get(s) for s in shards), default=0.0)
            return get(out) / n_chips + mx

        coll = {k: field(lambda t, k=k: t.collectives[k]) for k in KINDS}
        names = set(out.bytes_by_op).union(*(s.bytes_by_op for s in shards))
        breakdown = {k: field(lambda t, k=k: t.bytes_by_op.get(k, 0.0))
                     for k in names}
        return {"flops": field(lambda t: t.flops),
                "conv_flops": field(lambda t: t.conv_flops),
                "bytes": field(lambda t: t.bytes),
                "flops_k": field(lambda t: t.flops_k),
                "bytes_k": field(lambda t: t.bytes_k),
                "collectives": coll, "bytes_by_op": breakdown}

    def totals(self) -> dict:
        """Every scope's counts summed (the whole step on one device; a
        body that stands for several shards counts for each)."""
        out = Tally()
        for key, t in self.tallies.items():
            w = self.stands_for.get(key, 1)
            for k in ("flops", "conv_flops", "bytes", "flops_k", "bytes_k"):
                setattr(out, k, getattr(out, k) + w * getattr(t, k))
            for k in KINDS:
                out.collectives[k] += w * t.collectives[k]
            for name, (c, f, b) in t.regions.items():
                r = out.regions[name]
                r[0] += w * c
                r[1] += w * f
                r[2] += w * b
        return out.as_dict()


def _conv_flops(args, out) -> float:
    x, w = args[0], args[1]
    groups = args[8] if len(args) > 8 else 1
    per_out = (x.shape[1] // groups) * math.prod(w.shape[2:])
    return 2.0 * out.numel() * per_out


def active() -> Optional[StepCounter]:
    """The counter whose mode is on this thread's dispatch stack, if any."""
    if not _entered:
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, _Mode):
            return mode.counter
    return None


# --------------------------------------------------------------- region --

class _Region:
    """A kernel call: nothing inside counts toward the kernelized totals;
    at the end its inputs and outputs (:meth:`io`) and ``flops`` do."""

    def __init__(self, counter: StepCounter, name: str, flops: float):
        self.counter, self.name, self.flops = counter, name, flops
        self.inputs, self.outputs = [], []

    def __enter__(self):
        tls = self.counter._tls
        tls.depth = getattr(tls, "depth", 0) + 1
        return self

    def io(self, *inputs, out=None):
        """The kernel's inputs (read once) and its outputs ``out``
        (written once, and live after the region)."""
        self.inputs = _tensors(inputs)
        self.outputs = _tensors(out)

    def __exit__(self, exc_type, *exc):
        c = self.counter
        c._tls.depth -= 1
        if exc_type is None and c._tls.depth == 0:
            c._credit(self.name, self.flops, self.inputs + self.outputs)
            for t in self.outputs:
                c._track(t, kernelized=True)
        return False


# a region's own FLOPs from the shapes its wrapper passes
_REGION_FLOPS = {
    "flash_attention": lambda q, k, v, causal: attention_flops(
        q[0], q[1], k[1], q[2], q[3], v[-1], causal),
    "ssd_scan": lambda xh, bv: ssd_flops(*xh, bv[-1]),
}


def region(name: str, *args):
    """The context a kernel wrapper runs in (``kernels/_region.py``): a
    no-op unless a counter is active on this thread, which then reckons
    the region's FLOPs from ``args``."""
    c = active()
    if c is None:
        return _region.NULL
    flops = _REGION_FLOPS[name](*args) if name in _REGION_FLOPS else 0.0
    return _Region(c, name, flops)


_region.install(region)


class shard_scope:
    """Run a shard body of shard ``i`` under ``counter`` (None: nothing):
    the shard's ops are credited to it, in whichever thread it runs.
    ``stands_for``: the shards this body's count stands for (a meta
    mesh's one body stands for all)."""

    def __init__(self, counter: Optional[StepCounter], i: int, *,
                 stands_for: int = 1):
        self.counter, self.i, self.n = counter, i, stands_for
        self.mode = None

    def __enter__(self):
        c = self.counter
        if c is None:
            return self
        c.stands_for[self.i] = self.n
        self.prev = c._shard()
        c._tls.shard = self.i
        if active() is not c:
            self.mode = _Mode(c)
            self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        c = self.counter
        if c is None:
            return False
        if self.mode is not None:
            self.mode.__exit__(*exc)
        c._tls.shard = self.prev
        return False


def collective(kind: str, nbytes: float, n: int):
    """Record a collective of ``nbytes`` among ``n`` members on this
    thread's counter, if any."""
    c = active()
    if c is not None:
        c.collective(kind, nbytes, n)


# -------------------------------------------------------------- analyze --

def _walk(tree, path=()):
    """(path, leaf) of a dict tree, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        yield path, tree


def param_gathers(cfg, policy, *, train: bool, microbatches: int = 1
                  ) -> dict:
    """Per-chip bytes of the FSDP gathers a policy implies for the
    parameters (f32 masters in training, bf16 for serving), which the
    port does not run (``constrain`` returns its tensor): every parameter
    split over the batch axes is all-gathered over them once a forward
    (``microbatches`` times in a train step) and, in a train step, its
    gradient reduce-scattered once.  The MoE experts that ``shard_map``
    takes sharded (``wi``, ``wo`` of an MoE sublayer, when the policy's
    'model' axis divides the experts and the RRJ or its decode twin runs)
    are gathered inside its body, where the step counts them, and are
    left out here."""
    from repro_torch.models import api
    from repro_torch.train import train_step as ts

    tp = policy.mesh.shape.get("model", 1)
    in_body = cfg.moe is not None and tp > 1 and cfg.moe.num_experts % tp == 0
    batch_axes = set(P.names(policy.rules.get("batch")))
    shapes = dict(_walk(api.param_shapes(cfg)))
    out = {"all-gather": 0.0, "reduce-scatter": 0.0}
    for path, sh in _walk(ts.param_shardings(cfg, policy)):
        if in_body and path[-1] in ("wi", "wo") \
                and path[-2].endswith("_moe"):
            continue
        n = math.prod(policy.mesh.shape[a] for e in sh.spec
                      for a in P.names(e) if a in batch_axes)
        if n == 1:
            continue
        shard = math.prod(sh.shard_shape(shapes[path])) * (4 if train else 2)
        out["all-gather"] += ring_bytes("all-gather", shard * n, n) * (
            microbatches if train else 1)
        if train:
            out["reduce-scatter"] += ring_bytes("reduce-scatter", shard, n)
    return out


def analyze(cfg, shape, count: StepCounter, n_chips: int, *, spec=None,
            top: int = 12) -> dict:
    """The three-term roofline of a counted step, per chip, on ``spec``
    (``costmodel.H100`` if None).  MODEL_FLOPS is 6 N D for a train step,
    2 N D for a prefill step and 2 N B for a decode step, N the active
    parameters."""
    from repro_torch.core import costmodel
    spec = spec or costmodel.H100
    pc = count.per_chip(n_chips)
    coll = dict(pc["collectives"])
    coll["total"] = sum(coll[k] for k in KINDS)
    gath = dict(count.param_gathers)
    gath["total"] = sum(gath.values())
    net = coll["total"] + gath["total"]
    terms = costmodel.roofline_terms(pc["flops"], pc["bytes"], net, spec)
    terms_k = costmodel.roofline_terms(pc["flops_k"], pc["bytes_k"], net,
                                       spec)
    _, n_active = cfg.param_counts()
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mf = (costmodel.model_flops if shape.kind == "train"
          else costmodel.model_flops_fwd)(n_active, tokens) / n_chips
    at_peak = mf / spec.peak_flops_bf16
    breakdown = sorted(pc["bytes_by_op"].items(), key=lambda kv: -kv[1])
    return {
        "step_flops_per_chip": pc["flops"],
        "step_conv_flops_per_chip": pc["conv_flops"],
        "step_bytes_per_chip": pc["bytes"],
        "step_flops_per_chip_kernelized": pc["flops_k"],
        "step_bytes_per_chip_kernelized": pc["bytes_k"],
        "collective_bytes_per_chip": coll,
        "param_gather_bytes_per_chip": gath,
        **terms,
        "compute_s_kernelized": terms_k["compute_s"],
        "memory_s_kernelized": terms_k["memory_s"],
        "dominant_kernelized": terms_k["dominant"],
        "bound_s_kernelized": terms_k["bound_s"],
        "model_flops_per_chip": mf,
        "useful_flop_ratio": mf / max(pc["flops"], 1.0),
        "roofline_fraction": at_peak / max(terms["bound_s"], 1e-12),
        "roofline_fraction_kernelized":
            at_peak / max(terms_k["bound_s"], 1e-12),
        "peak_live_bytes": count.peak_live,
        "peak_live_bytes_kernelized": count.peak_live_k,
        "memory_breakdown": breakdown[:top],
    }
