"""Serve a small model with batched requests through the NAM KV pool:
continuous batching, RSI-CAS slot allocation (the ``cas_lock`` kernel on
the card), two request waves.  A twin of ``examples/serve_lm.py``: the
prompts are the JAX example's (numpy ``RandomState(0)``), the weights are
drawn on the device from seed 0.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch._bits import np_u32, resolve_device
from repro_torch.configs import get_config, reduce_config
from repro_torch.models import api
from repro_torch.serving.engine import Request, ServeEngine


def requests(vocab_size: int) -> list:
    """Two waves of 4 requests: prompts of 3..6 tokens drawn from
    ``RandomState(0)``, 6..12 new tokens."""
    rng = np.random.RandomState(0)
    return [[Request(rid=wave * 4 + i,
                     prompt=rng.randint(0, vocab_size, size=(3 + i,)),
                     max_new_tokens=6 + 2 * i)
             for i in range(4)] for wave in range(2)]


def serve(eng, waves) -> dict:
    """Run each wave through the engine; {rid: tokens out} and the slot
    lock words after the last release."""
    outs = {}
    for reqs in waves:
        done = eng.run(reqs)
        for r in sorted(done, key=lambda r: r.rid):
            print(f"req {r.rid}: {len(r.prompt)} prompt toks -> {r.out}")
            outs[r.rid] = list(r.out)
    words = np_u32(eng.slot_words).tolist()
    print("slot lock words after release:", np.array(words))
    return {"outs": outs, "slot_words": words}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = reduce_config(get_config("glm4-9b"))
    params = api.init_params(cfg, torch.Generator(dev).manual_seed(0),
                             device=dev)
    eng = ServeEngine(cfg, params, slots=4, max_seq=64, device=dev)
    return serve(eng, requests(cfg.vocab_size))


if __name__ == "__main__":
    main()
