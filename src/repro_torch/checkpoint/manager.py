"""Checkpointing with rename-committed manifests (decentralized metadata,
§3.2); a port of ``repro.checkpoint.manager`` in its on-disk format.

Every save writes the arrays to a fresh directory, then *commits* by
renaming it into place: the filesystem analogue of the paper's CAS on
metadata.  Concurrent committers race on the rename and exactly one
wins; a crash mid-save leaves no partly visible checkpoint.

The format is the JAX package's: ``step-<10 digits>/arrays.npz`` holds
the tree's leaves as ``a0, a1, ...`` in JAX's flatten order (dict keys
sorted), beside ``manifest.json``.  So a checkpoint written by either
package restores in the other.  Restore puts the arrays on the device of
the tree it restores into.  Async saves run on a background thread.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
import shutil
import time

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_unflatten


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending = None

    # ------------------------------------------------------------- save --

    def save(self, step: int, tree, *, extra: dict = None,
             async_: bool = False):
        leaves, _ = tree_flatten(tree)
        host = [_host(x) for x in leaves]          # device -> host copy
        if async_:
            self.wait()
            self._pending = self._pool.submit(self._write, step, host,
                                              extra or {})
            return None
        return self._write(step, host, extra or {})

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _write(self, step: int, leaves, extra: dict):
        tmp = os.path.join(self.dir,
                           f".tmp-{step}-{os.getpid()}-{time.time_ns()}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": l for i, l in enumerate(leaves)})
        manifest = {"step": step, "num_arrays": len(leaves),
                    "extra": extra, "time": time.time()}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(self.dir, f"step-{step:010d}")
        try:
            os.rename(tmp, final)                 # the commit: one winner
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)  # lost the race
            return final
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step-{s:010d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore --

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step-"):
                out.append(int(name.split("-")[1]))
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like_tree, *, step: int = None):
        """Restore into the structure, devices and dtypes of
        ``like_tree``.  Returns (tree, manifest)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step-{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(path, "arrays.npz"))
        leaves, treedef = tree_flatten(like_tree)
        if manifest["num_arrays"] != len(leaves):
            raise ValueError(f"checkpoint holds {manifest['num_arrays']} "
                             f"arrays, the tree {len(leaves)}")
        out = []
        for i, like in enumerate(leaves):
            arr = data[f"a{i}"]
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"array a{i} has shape {arr.shape}, the "
                                 f"tree's leaf {tuple(like.shape)}")
            out.append(torch.from_numpy(np.array(arr)).to(
                device=like.device, dtype=like.dtype))
        return tree_unflatten(treedef, out), manifest
