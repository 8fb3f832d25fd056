"""Training launcher (a port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
      --sync-mode 'paramserver(staleness=4)' [--steps 50 --seq-len 256]
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
      --smoke --device cpu --steps 4 --seq-len 32

Without ``--device`` it runs on the card; ``--smoke`` takes the reduced
same-family config.  Parameters are drawn from seed 0 on the device.
Checkpoint/restart: re-launching with the same ``--ckpt-dir`` resumes.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch._bits import resolve_device
from repro_torch.configs import get_config, reduce_config
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro-torch-ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--sync-mode", default="allreduce",
                    help="'allreduce' (fused step) or "
                         "'paramserver(staleness=k)': the §6 NAM parameter "
                         "server with bounded-stale pulls and compressed "
                         "pushes")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_config(cfg)
    tcfg = TrainerConfig(steps=args.steps, global_batch=args.global_batch,
                         seq_len=args.seq_len, microbatches=args.microbatches,
                         checkpoint_dir=args.ckpt_dir,
                         checkpoint_every=args.checkpoint_every,
                         sync_mode=args.sync_mode)
    tr = Trainer(cfg, tcfg, device=device)
    resumed = tr.maybe_restore()
    print(f"[train] arch={cfg.name} resumed={resumed} start_step={tr.step}")
    log = tr.run()
    for step, loss in log:
        print(f"step {step:6d}  loss {loss:.4f}")
    if tr.comm_log:
        c = tr.comm_log[-1]
        print(f"[train] ps comm: push {c['push_wire_bytes']:,}B compressed "
              f"(f32 {c['grad_bytes_f32']:,}B) "
              f"model t_ps_step={c['t_ps_step_model_s'] * 1e3:.3f}ms vs "
              f"t_allreduce={c['t_allreduce_model_s'] * 1e3:.3f}ms")
        for name, m in c.get("profiles", {}).items():
            verdict = ("ps" if m["t_ps_step_model_s"]
                       < m["t_allreduce_model_s"] else "allreduce")
            print(f"[train]   {name:<12} t_ps_step="
                  f"{m['t_ps_step_model_s'] * 1e3:.3f}ms "
                  f"t_allreduce={m['t_allreduce_model_s'] * 1e3:.3f}ms "
                  f"-> {verdict}")
    print(f"[train] done at step {tr.step}")


if __name__ == "__main__":
    main()
