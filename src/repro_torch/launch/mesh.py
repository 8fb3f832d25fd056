"""Meshes of shards on one card, and ``shard_map`` over them (a port of
``repro.launch.mesh``, with the ``shard_map`` and collectives of
``jax.experimental.shard_map`` / ``jax.lax`` that the MoE dispatch uses).

A :class:`Mesh` names the axes of a grid of shards, ``("data",
"model")`` or ``("pod", "data", "model")``.  Shard i sits at the
row-major coordinates of i, as ``jax.make_mesh`` orders its devices.
The shards run on one device through a
:class:`~repro_torch.fabric.transport.MeshTransport` of ``mesh.size``
shards (a host thread a shard, taking turns between collectives), made
when something first runs on the mesh: building a mesh starts no thread
and touches no device.

:func:`shard_map` splits every dimension its ``in_specs`` name into
blocks (views) and runs the body once per shard on that shard's blocks;
``out_specs`` joins the shards' outputs the same way (an output
dimension no spec entry names is taken from the shards at coordinate 0
of the axes the spec leaves out).  Inside a body, :meth:`Mesh.
axis_index`, :meth:`Mesh.all_gather`, :meth:`Mesh.psum`,
:meth:`Mesh.psum_scatter` and :meth:`Mesh.all_to_all` act over a named
axis: among the shards that share every other coordinate, combined in
the order of that axis.  These are ``shard_map``'s collectives, not the
fabric's verbs: they add nothing to ``transport.stats()``.  Under a
step counter (``launch/roofline.py``) every shard body is counted as
that shard's, and each collective records its bytes under the ring
model.
"""
from __future__ import annotations

import itertools
import math
import threading
from typing import Optional

import torch

from repro_torch._bits import resolve_device
from repro_torch.fabric.transport import MeshTransport
from repro_torch.launch import roofline
from repro_torch.sharding.policy import NamedSharding, P


class Mesh:
    """A named grid of ``prod(shape)`` shards on one device."""

    def __init__(self, shape, axis_names, *, device=None):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or min(shape, default=0) < 1:
            raise ValueError(f"a mesh of shape {shape} over axes "
                             f"{axis_names}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.size = math.prod(shape)
        self._device = device
        self._transport: Optional[MeshTransport] = None
        self._one = threading.local()    # a body standing for every shard

    @property
    def device(self) -> torch.device:
        if self._transport is None:
            return resolve_device(self._device)
        return self._transport.device

    @property
    def on_meta(self) -> bool:
        """A mesh on the meta device: tensors are shapes alone, so every
        shard's body does the same work, and ``shard_map`` runs one body,
        shard 0's, which stands for every shard (no thread is started)."""
        return self._device is not None and \
            torch.device(self._device).type == "meta"

    @property
    def transport(self) -> MeshTransport:
        if self._transport is None:
            self._transport = MeshTransport(
                self.size, axis="mesh", device=resolve_device(self._device))
        return self._transport

    def coords(self, i: int) -> tuple:
        """Shard i's coordinates, row-major (the last axis fastest)."""
        out = []
        for a in reversed(self.axis_names):
            i, c = divmod(i, self.shape[a])
            out.append(c)
        return tuple(reversed(out))

    def index(self, coords) -> int:
        i = 0
        for a, c in zip(self.axis_names, coords):
            i = i * self.shape[a] + c
        return i

    # ----------------------------------------------- inside a shard_map ---

    def shard_index(self) -> int:
        if getattr(self._one, "on", False):
            return 0
        return self.transport.shard_index()

    def axis_index(self, axis: str) -> int:
        return self.coords(self.shard_index())[self.axis_names.index(axis)]

    def _members(self, axis) -> tuple:
        """(the shards that share every coordinate but ``axis``'s, in the
        order of ``axis`` (a name or a tuple of names, the first major),
        this shard's position among them)."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        me = self.shard_index()
        c = list(self.coords(me))
        pos = [self.axis_names.index(a) for a in axes]
        members = []
        for combo in itertools.product(*(range(self.shape[a])
                                         for a in axes)):
            for p, v in zip(pos, combo):
                c[p] = v
            members.append(self.index(c))
        return members, members.index(me)

    def _collect(self, kind: str, x, axis) -> tuple:
        members, me = self._members(axis)
        if getattr(self._one, "on", False):
            return [x] * len(members), me
        vals = self.transport.gather(f"mesh.{kind}", x)
        return [vals[m] for m in members], me

    def all_gather(self, x, axis, dim: int = 0, tiled: bool = True):
        """The members' ``x`` concatenated on ``dim`` (``tiled``) or
        stacked on a new ``dim``."""
        xs, _ = self._collect("all_gather", x, axis)
        out = torch.cat(xs, dim) if tiled else torch.stack(xs, dim)
        roofline.collective("all-gather", roofline.nbytes(out), len(xs))
        return out

    def psum(self, x, axis):
        """The members' ``x`` summed in the order of ``axis``, in x's
        dtype."""
        xs, _ = self._collect("psum", x, axis)
        roofline.collective("all-reduce", roofline.nbytes(x), len(xs))
        out = xs[0]
        for y in xs[1:]:
            out = out + y
        return out

    def psum_scatter(self, x, axis, dim: int = 0):
        """Block j (of as many as ``axis`` has members) of the members'
        ``x`` along ``dim``, summed in the order of ``axis``: member j
        keeps block j (``tiled``, as ``jax.lax.psum_scatter``)."""
        xs, me = self._collect("psum_scatter", x, axis)
        n = len(xs)
        if x.shape[dim] % n:
            raise ValueError(f"psum_scatter: dimension {dim} of "
                             f"{tuple(x.shape)} does not split into {n} "
                             "blocks")
        b = x.shape[dim] // n
        out = xs[0].narrow(dim, me * b, b).clone()
        for y in xs[1:]:
            out += y.narrow(dim, me * b, b)
        roofline.collective("reduce-scatter", roofline.nbytes(out), n)
        return out

    def all_to_all(self, x, axis, split: int = 0, concat: int = 0,
                   tiled: bool = False):
        """Member j receives block j of every member's ``x`` along
        ``split``, in member order along ``concat``.  Untiled, ``split``
        has one index a member and the received blocks are stacked on a
        new ``concat``; tiled, ``split`` divides into equal blocks that
        are concatenated on ``concat``."""
        xs, me = self._collect("all_to_all", x, axis)
        n = len(xs)
        roofline.collective("all-to-all", roofline.nbytes(x), n)
        if tiled:
            if x.shape[split] % n:
                raise ValueError(f"all_to_all: dimension {split} of "
                                 f"{tuple(x.shape)} does not split into "
                                 f"{n} blocks")
            b = x.shape[split] // n
            return torch.cat([v.narrow(split, me * b, b) for v in xs],
                             concat)
        if x.shape[split] != n:
            raise ValueError(f"all_to_all: dimension {split} of "
                             f"{tuple(x.shape)} is not the axis size {n}")
        return torch.stack([v.select(split, me) for v in xs], concat)


def shard_map(body, mesh: Mesh, in_specs, out_specs):
    """``body`` once per shard of ``mesh`` over the blocks of its
    arguments (``in_specs``, one :class:`P` an argument), joined by
    ``out_specs`` (a :class:`P`, or a tuple of them for a tuple of
    outputs).  The shards run with the caller's grad and inference modes;
    a dimension that does not divide by its shard count raises
    ``ValueError`` before any shard runs.  On a meta mesh one body stands
    for every shard (:attr:`Mesh.on_meta`)."""
    single = isinstance(out_specs, P)
    outs_spec = (out_specs,) if single else tuple(out_specs)

    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments for {len(in_specs)} "
                             "in_specs")
        n = mesh.size
        shardings = [NamedSharding(mesh, P(*s)) for s in in_specs]
        blocks = [[sh.block(a, i) for sh, a in zip(shardings, args)]
                  for i in range(1 if mesh.on_meta else n)]
        outs = [None] * n
        grad = torch.is_grad_enabled()
        infer = torch.is_inference_mode_enabled()
        counter = roofline.active()

        def shard(token):
            i = mesh.shard_index()
            with torch.inference_mode(infer), torch.set_grad_enabled(grad), \
                    roofline.shard_scope(counter, i):
                out = body(*blocks[i])
            outs[i] = (out,) if single else tuple(out)
            return token

        if mesh.on_meta:
            mesh._one.on = True
            try:
                with torch.inference_mode(infer), \
                        torch.set_grad_enabled(grad), \
                        roofline.shard_scope(counter, 0, stands_for=n):
                    out = body(*blocks[0])
            finally:
                mesh._one.on = False
            outs = [(out,) if single else tuple(out)] * n
        else:
            mesh.transport.run(shard, (torch.empty(n, device="meta"),),
                               True)
        joined = tuple(_join(mesh, spec, [o[j] for o in outs])
                       for j, spec in enumerate(outs_spec))
        return joined[0] if single else joined
    return run


def _join(mesh: Mesh, spec, values):
    """The tensor whose ``spec`` blocks the shards' ``values`` are.  On a
    meta mesh the block copies are one copy of the whole (the same
    bytes)."""
    sh = NamedSharding(mesh, P(*spec))
    v0 = values[0]
    parts = sh.parts(v0.dim())
    out = v0.new_empty(tuple(s * k for s, k in zip(v0.shape, parts)))
    if mesh.on_meta:
        return out.copy_(torch.empty_like(out))
    named = {a for e in sh.spec for a in P.names(e)}
    rest = [k for k, a in enumerate(mesh.axis_names) if a not in named]
    for i, v in enumerate(values):
        if all(mesh.coords(i)[k] == 0 for k in rest):
            sh.block(out, i).copy_(v)
    return out


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """Single pod: 256 shards as (data=16, model=16).  Multi-pod: 2 pods
    with a leading 'pod' (pure DP) axis.  A description: nothing runs,
    and no device is asked for, until something runs on it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device=device)


def make_host_mesh(data: int = 1, model: int = 1, *, device=None) -> Mesh:
    """A (data, model) mesh of data * model shards on ``device`` (the card
    unless the caller asks for the CPU)."""
    return Mesh((data, model), ("data", "model"),
                device=resolve_device(device))
