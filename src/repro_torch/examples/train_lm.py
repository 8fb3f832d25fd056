"""End to end: train a ~100M-parameter dense LM for a few hundred
steps on synthetic data with checkpointing and restart.  A twin of
``examples/train_lm.py``.

  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 10 --tiny --device cpu

The ~100M config is a 12L/768d/12H dense transformer (GPT-2-small-like);
the loop runs the whole production path: the work-stealing loader, the
train step, asynchronous checkpoints (``checkpoint/manager.py``, JAX's
on-disk format) and resume: run it again with the same ``--ckpt-dir`` and
it restores the last checkpoint and goes on from its step.
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile

from repro_torch._bits import resolve_device
from repro_torch.configs import reduce_config
from repro_torch.configs.base import ModelConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

LM_100M = ModelConfig(
    name="demo-100m", family="dense", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=12, d_ff=3072, vocab_size=32768,
    head_dim=64, tie_embeddings=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true",
                    help="~1M params instead of ~100M")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro-torch-train-lm"))
    ap.add_argument("--sync-mode", default="allreduce",
                    help="'allreduce' or 'paramserver(staleness=k)': the "
                         "§6 NAM parameter server")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduce_config(LM_100M) if args.tiny else LM_100M
    n, _ = cfg.param_counts()
    print(f"training {cfg.name}: {n/1e6:.1f}M params, {args.steps} steps")
    tcfg = TrainerConfig(steps=args.steps, global_batch=args.global_batch,
                         seq_len=args.seq_len, checkpoint_dir=args.ckpt_dir,
                         checkpoint_every=50, log_every=10,
                         sync_mode=args.sync_mode)
    tr = Trainer(cfg, tcfg, device=dev)
    resumed = tr.maybe_restore()
    start = tr.step
    print(f"resumed={resumed} start_step={start}")
    log = tr.run()
    for s, l in log:
        print(f"step {s:6d}  loss {l:.4f}")
    out = {"params": n, "resumed": resumed, "start_step": start,
           "step": tr.step, "log": [list(e) for e in log],
           "finite": all(math.isfinite(l) for _, l in log)}
    if log:
        first, last = log[0][1], log[-1][1]
        print(f"loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return out


if __name__ == "__main__":
    main()
