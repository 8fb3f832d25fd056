"""Logical-axis sharding policy (a port of ``repro.sharding.policy``).

Models name the axes of their tensors *logically* ("batch", "seq",
"heads", "ff", "experts", "embed", "vocab", "kv_seq", ...).  A
:class:`ShardingPolicy` maps those names to the axes of a mesh
(:class:`repro_torch.launch.mesh.Mesh`).  This is the NAM layout table:
parameters live in the pool sharded over (fsdp='data') x
(tensor='model'); activations are batch-sharded over (pod, data) with
the sequence sharded over 'model' between blocks.

PyTorch runs eagerly on one card, so a sharding constraint changes no
values: :func:`constrain` returns its tensor.  What a policy changes is
the MoE dispatch (``models/moe.py``), which reads the mesh and the rules
of the policy that :func:`set_policy` installs for the calling thread.
With no policy installed, every path runs as it does without one.

:class:`P` is the port's ``PartitionSpec`` (equal, entry for entry, to
JAX's, which folds a one-name tuple to the name and an empty one to
None) and :class:`NamedSharding` a spec on a mesh, which cuts a shard's
block out of a tensor as a view.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field
from typing import Optional

# Activation logical axes -> mesh axes (None = replicated / unsharded).
# Parameter logical axes use the same table ('embed' is the FSDP dim).
DEFAULT_RULES: dict[str, object] = {
    # activations
    "batch": ("data",),          # ('pod','data') on the multi-pod mesh
    "seq_sharded": "model",      # sequence-parallel residual stream
    "seq": None,                 # full sequence (inside attention blocks)
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "experts": "model",
    "vocab": "model",
    "kv_seq": None,              # decode KV cache sequence dim
    "kv_batch": ("data",),
    # parameters
    "embed": "data",             # FSDP shard of the d_model dim (NAM pool)
    "ssm_inner": "model",
    "stack": None,               # scan-stacked layer-group dim
    "state": None,
}


def _entry(e):
    """One spec entry as JAX keeps it: None, a mesh axis name, or a tuple
    of two or more names."""
    if e is None or isinstance(e, str):
        return e
    names = tuple(e)
    if not names:
        return None
    return names[0] if len(names) == 1 else names


class P(tuple):
    """A partition spec: one entry a dimension, each None (not split), a
    mesh axis name, or a tuple of names (split over their product, the
    first name major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"

    @staticmethod
    def names(entry) -> tuple:
        """The mesh axes of one entry, as a tuple."""
        if entry is None:
            return ()
        return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass(frozen=True)
class NamedSharding:
    """``spec`` on ``mesh``: dimension d of a tensor is cut into as many
    equal blocks as the mesh axes of ``spec[d]`` hold shards, and shard i
    holds the block at its coordinates on those axes."""
    mesh: object
    spec: P

    def parts(self, ndim: int) -> list:
        """Blocks along each of ``ndim`` dimensions."""
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        if len(spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"{ndim} dimensions of the tensor")
        return [math.prod(self.mesh.shape[a] for a in P.names(e))
                for e in spec]

    def shard_shape(self, shape) -> tuple:
        """The shape of one shard's block of a tensor of ``shape``; every
        split dimension must divide by its shard count."""
        out = []
        for d, (n, k) in enumerate(zip(shape, self.parts(len(shape)))):
            if n % k:
                raise ValueError(f"dimension {d} of shape {tuple(shape)} "
                                 f"does not split into {k} blocks under "
                                 f"{self.spec} on mesh "
                                 f"{dict(self.mesh.shape)}")
            out.append(n // k)
        return tuple(out)

    def block_index(self, i: int, ndim: int) -> list:
        """Shard i's block number along each dimension."""
        coords = dict(zip(self.mesh.axis_names, self.mesh.coords(i)))
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        out = []
        for e in spec:
            b = 0
            for a in P.names(e):
                b = b * self.mesh.shape[a] + coords[a]
            out.append(b)
        return out

    def block(self, x, i: int):
        """Shard i's block of ``x``, a view."""
        shape = self.shard_shape(x.shape)
        for d, (b, n) in enumerate(zip(self.block_index(i, x.dim()),
                                       shape)):
            if n != x.shape[d]:
                x = x.narrow(d, b * n, n)
        return x


@dataclass
class ShardingPolicy:
    mesh: object
    rules: dict = field(default_factory=dict)

    def resolve(self, logical_axes) -> P:
        return P(*(None if name is None else self.rules.get(name, None)
                   for name in logical_axes))

    def sharding(self, logical_axes) -> NamedSharding:
        return NamedSharding(self.mesh, self.resolve(logical_axes))


# §Perf toggle (JAX: launch/dryrun.py --opts decode_tp)
DECODE_TP = False

_tls = threading.local()


def current_policy() -> Optional[ShardingPolicy]:
    """The calling thread's policy (None: no policy).  A mesh's shard
    bodies run on threads of their own, where it is None: they take what
    they need as arguments."""
    return getattr(_tls, "policy", None)


@contextlib.contextmanager
def set_policy(policy: Optional[ShardingPolicy]):
    prev = current_policy()
    _tls.policy = policy
    try:
        yield policy
    finally:
        _tls.policy = prev


def constrain(x, *logical_axes):
    """Annotate activation x with logical axes: x itself.  Under a policy
    the axes must name every dimension, as JAX asserts."""
    if current_policy() is not None and x.dim() != len(logical_axes):
        raise ValueError(f"constrain: {len(logical_axes)} logical axes "
                         f"{logical_axes} for a tensor of shape "
                         f"{tuple(x.shape)}")
    return x


def param_pspec(logical_axes, rules=None) -> P:
    """Partition spec of a parameter's logical axes under given rules."""
    rules = dict(DEFAULT_RULES, **(rules or {}))
    return ShardingPolicy(mesh=None, rules=rules).resolve(logical_axes)


def make_policy(mesh, *, shape_kind: str = "train",
                overrides: Optional[dict] = None) -> ShardingPolicy:
    """The standard policy for a mesh and an input-shape kind.

    train/prefill: batch over (pod?, data); sequence-parallel residual.
    decode:        batch over (pod?, data); KV sequence over 'model'
                   (with ``DECODE_TP``: batch replicated, KV sequence over
                   (data, model)).
    long_decode:   batch unsharded, KV sequence sharded over (pod?, data).
    """
    axes = mesh.axis_names
    batch_axes = tuple(a for a in ("pod", "data") if a in axes)
    rules = dict(DEFAULT_RULES)
    rules["batch"] = batch_axes
    rules["kv_batch"] = batch_axes
    rules["embed"] = "data" if "data" in axes else None
    if shape_kind == "decode":
        rules["kv_seq"] = "model"
        rules["kv_heads"] = None
        if DECODE_TP:
            rules["batch"] = None
            rules["kv_batch"] = None
            rules["kv_seq"] = ("data", "model")
    if shape_kind == "long_decode":
        rules["batch"] = None
        rules["kv_batch"] = None
        rules["kv_seq"] = batch_axes
        rules["seq_sharded"] = "model"
    if overrides:
        rules.update(overrides)
    return ShardingPolicy(mesh=mesh, rules=rules)
