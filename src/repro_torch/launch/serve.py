"""Serving launcher: batched requests through the dense ``ServeEngine``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b --smoke \
      --device cpu --requests 6 --max-new 12

Without ``--device`` it runs on the card.  Weights are drawn from seed 0
on that device; ``--smoke`` takes the reduced config.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch._bits import resolve_device
from repro_torch.configs import get_config, reduce_config
from repro_torch.models import api
from repro_torch.serving.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=128)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_config(cfg)
    params = api.init_params(cfg, torch.Generator(device).manual_seed(0),
                             device=device)
    eng = ServeEngine(cfg, params, slots=args.slots, max_seq=args.max_seq,
                      device=device)
    rng = np.random.RandomState(0)
    waves = [
        [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, size=(4,)),
                 max_new_tokens=args.max_new)
         for i in range(w, min(w + args.slots, args.requests))]
        for w in range(0, args.requests, args.slots)
    ]
    for wave in waves:
        done = eng.run(wave)
        for r in done:
            print(f"req {r.rid}: prompt={r.prompt.tolist()} -> out={r.out}")
    print(f"[serve] completed {args.requests} requests")


if __name__ == "__main__":
    main()
