"""Carry a JAX parameter tree into the port.

``params_from_numpy(cfg, tree)`` takes the JAX package's parameter pytree
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``),
stacked over groups as ``repro.models.lm.build`` and
``repro.models.encdec.build`` make them (``groups/b0_attn_mlp/s0_attn/wq``
of shape (G, d, h, hd); MoE experts ``groups/b1_attn_moe/s1_moe/wi`` of
shape (G, E, d, 2F); deepseek's unstacked ``pre`` layer; a VLM's
``mod_proj``; whisper's ``mod_proj``, ``enc_pos``, ``enc_groups`` and
``enc_norm``), and returns the port's parameters: the same tree of
tensors.  It checks every name and shape against
:func:`repro_torch.models.api.param_shapes`.  This is how the tests run
both packages on the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._bits import resolve_device
from repro_torch.models import api


def params_from_numpy(cfg, tree, *, dtype=None, device=None):
    """dtype: the parameters' dtype (None keeps each array's); device: the
    card unless the caller asks for the CPU."""
    device = resolve_device(device)

    def walk(want, got, path):
        if isinstance(want, dict):
            if not isinstance(got, dict) or set(got) != set(want):
                have = sorted(got) if isinstance(got, dict) else type(got)
                raise ValueError(f"{path or 'params'}: keys {have}, "
                                 f"expected {sorted(want)}")
            return {k: walk(want[k], got[k], f"{path}/{k}".lstrip("/"))
                    for k in want}
        arr = np.asarray(got)
        if tuple(arr.shape) != tuple(want):
            raise ValueError(f"{path}: shape {arr.shape}, expected {want}")
        t = torch.from_numpy(np.array(arr, copy=True))
        return t.to(device=device, dtype=dtype or t.dtype)

    return walk(api.param_shapes(cfg), tree, "")
