"""KV-cache paging: a bit-exact block codec between the dense decode state
and the two-tier NAM block space (the port of ``repro.serving.paging``).

The decode state (``models.api.init_decode_state``) is a fixed-shape
pytree: per-sublayer KV caches stacked ``(G, slots, max_seq, ...)``, an
optional ``"pre"`` subtree shaped ``(slots, max_seq, ...)``, sequence-free
recurrent state, and one shared scalar ``"pos"``.  :class:`PagedKV`
classifies the leaves once, in JAX's leaf order
(:func:`repro_torch.tree.tree_flatten_with_path`), by their first key:

  * **paged** leaves have a ``max_seq`` axis right after the slot axis and
    are sliced into ``block_tokens``-row blocks per slot;
  * **aux** leaves are per-slot but sequence-free: one aux page per slot;
  * ``"pos"`` is shared and never paged.

A block packs every paged leaf's ``(slot, token-block)`` slice through the
router's word codec (``pack_fields(valid=False)`` / ``_unpack_leaf``), so
bf16 round-trips bit for bit and the packed words equal the JAX package's.
Words are int32 bit views of u32.

The state's leaves are updated **in place**: the port's decode step writes
its caches in place under ``torch.inference_mode``, so they are inference
tensors, and every write here runs under the same mode.  Extraction copies.
Slot and block indices are host ints.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.fabric import router
from repro_torch.tree import tree_flatten, tree_flatten_with_path


@dataclass(frozen=True)
class _LeafPlan:
    idx: int                 # position in tree_flatten(state) leaf order
    shape: tuple
    dtype: torch.dtype
    batch_axis: int
    seq_axis: Optional[int]  # None = aux (sequence-free per-slot state)
    words: int               # packed u32 lanes of one slot-slice


class PagedKV:
    """Block codec and slicing plan for one decode-state template (only
    its leaves' shapes and dtypes are read).  Raises on a per-slot subtree
    it does not know: paging is bit-exact or refuses."""

    def __init__(self, template, *, slots: int, max_seq: int,
                 block_tokens: int):
        if max_seq % block_tokens:
            raise ValueError("block_tokens must divide max_seq")
        self.slots = int(slots)
        self.max_seq = int(max_seq)
        self.block_tokens = int(block_tokens)
        self.blocks_per_slot = self.max_seq // self.block_tokens
        paths, self.treedef = tree_flatten_with_path(template)
        self.paged: List[_LeafPlan] = []
        self.aux: List[_LeafPlan] = []
        for i, (path, leaf) in enumerate(paths):
            key0 = str(path[0]) if path else ""
            if key0 == "pos":
                continue                       # shared decode clock
            if key0 == "caches":
                b = 1                          # (G, slots, [max_seq,] ...)
            elif key0 == "pre":
                b = 0                          # (slots, [max_seq,] ...)
            else:
                raise ValueError(
                    f"PagedKV: unknown decode-state subtree {key0!r} — "
                    "cannot guarantee bit-exact paging")
            shape = tuple(leaf.shape)
            if len(shape) <= b or shape[b] != self.slots:
                raise ValueError(
                    f"PagedKV: leaf {key0}[{i}] shape {shape} has no slot "
                    f"axis of size {self.slots} at axis {b}")
            seq = (b + 1 if len(shape) > b + 1 and shape[b + 1] == max_seq
                   else None)
            sl = list(shape)
            sl[b] = 1
            if seq is not None:
                sl[seq] = self.block_tokens
            words = router._leaf_row_words((1, math.prod(sl)), leaf.dtype)
            plan = _LeafPlan(i, shape, leaf.dtype, b, seq, words)
            (self.paged if seq is not None else self.aux).append(plan)
        self.block_words = sum(p.words for p in self.paged)
        self.aux_words = sum(p.words for p in self.aux)

    # ------------------------------------------------------- slicing ----

    def _slot_slice(self, plan: _LeafPlan, slot: int, j: Optional[int]):
        """Index tuple of ``slot``'s token-block ``j`` of one leaf (the
        whole slot when ``j`` is None)."""
        sl = [slice(None)] * len(plan.shape)
        sl[plan.batch_axis] = slice(slot, slot + 1)
        if plan.seq_axis is not None and j is not None:
            sl[plan.seq_axis] = slice(j * self.block_tokens,
                                      (j + 1) * self.block_tokens)
        return tuple(sl)

    def _pack(self, leaves, plans, slot: int, j: Optional[int]):
        cols = [leaves[p.idx][self._slot_slice(p, slot, j)].reshape(1, -1)
                for p in plans]
        packed, _, _ = router.pack_fields(cols, valid=False)
        return packed[0]

    def _unpack_into(self, leaves, plans, slot: int, j: Optional[int], row):
        col = 0
        for p in plans:
            lanes = row[None, col:col + p.words]
            col += p.words
            dst = leaves[p.idx][self._slot_slice(p, slot, j)]
            vals = router._unpack_leaf(lanes, (1, dst.numel()), p.dtype)
            dst.copy_(vals.reshape(dst.shape))

    # --------------------------------------------------------- codec ----

    def _flat(self, state):
        leaves, td = tree_flatten(state)
        if td != self.treedef:
            raise ValueError("decode state structure changed under PagedKV")
        return leaves

    def extract_block(self, state, slot: int, j: int) -> torch.Tensor:
        """Pack token-block ``j`` of ``slot`` -> ``(block_words,)``."""
        return self._pack(self._flat(state), self.paged, slot, j)

    def extract_blocks(self, state, slot: int, js: Sequence[int]):
        """Pack several blocks of one slot -> ``(len(js), block_words)``."""
        leaves = self._flat(state)
        return torch.stack([self._pack(leaves, self.paged, slot, j)
                            for j in js])

    @torch.inference_mode()
    def insert_block(self, state, slot: int, j: int, row):
        """Write a packed block back into ``slot`` (the bit-exact inverse),
        in place; returns ``state``."""
        self._unpack_into(self._flat(state), self.paged, slot, j, row)
        return state

    @torch.inference_mode()
    def insert_blocks(self, state, slot: int, js: Sequence[int], rows):
        leaves = self._flat(state)
        for i, j in enumerate(js):
            self._unpack_into(leaves, self.paged, slot, j, rows[i])
        return state

    def extract_aux(self, state, slot: int) -> torch.Tensor:
        """Pack the sequence-free per-slot state -> ``(aux_words,)``."""
        return self._pack(self._flat(state), self.aux, slot, None)

    @torch.inference_mode()
    def insert_aux(self, state, slot: int, row):
        self._unpack_into(self._flat(state), self.aux, slot, None, row)
        return state

    @torch.inference_mode()
    def zero_slot(self, state, slot: int):
        """Zero every per-slot leaf of ``slot`` (paged and aux), in place:
        rows no stored block covers must read as zeros, as the all-local
        baseline holds there."""
        leaves = self._flat(state)
        for p in self.paged + self.aux:
            leaves[p.idx][self._slot_slice(p, slot, None)].zero_()
        return state


# ------------------------------------------------------- block space -----


class BlockAllocator:
    """Deterministic free list over the cold region's block ids: ``alloc``
    returns the smallest free ids."""

    def __init__(self, n_blocks: int):
        self.n_blocks = int(n_blocks)
        self._free = list(range(self.n_blocks - 1, -1, -1))  # pop() = min

    @property
    def free(self) -> int:
        return len(self._free)

    def alloc(self, k: int = 1) -> List[int]:
        if k > len(self._free):
            raise RuntimeError(
                f"cold block space exhausted ({self.n_blocks} blocks)")
        return [self._free.pop() for _ in range(k)]

    def release(self, ids: Sequence[int]):
        for b in ids:
            self._free.append(int(b))
        self._free.sort(reverse=True)


@dataclass
class PageTable:
    """Per-request page map: token-block index -> cold block id, the aux
    page ids, and the request's extent (valid rows [0, extent) under the
    shared decode clock)."""

    blocks: Dict[int, int] = field(default_factory=dict)
    aux: List[int] = field(default_factory=list)
    extent: int = 0

    def block_ids(self) -> List[int]:
        """Stored sequence-block ids in token order."""
        return [self.blocks[j] for j in sorted(self.blocks)]

    def all_ids(self) -> List[int]:
        return self.block_ids() + list(self.aux)
