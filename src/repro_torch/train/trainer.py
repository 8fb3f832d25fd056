"""Fault-tolerant trainer (a port of ``repro.train.trainer``).

- checkpoint/restart: async rename-committed checkpoints (params,
  optimizer state, data cursor) in the JAX package's format; on
  (re)start the trainer restores the newest complete checkpoint and
  fast-forwards the deterministic pipeline;
- straggler mitigation: the loader is work-stealing
  (:mod:`repro_torch.data.pipeline`); step-time skew is tracked and logged
  (slow-step watchdog);
- sync mode: ``allreduce`` (the fused step: gradient, clip, optimizer) or
  ``paramserver(staleness=k)``: parameters live in the §6 NAM parameter
  server (:mod:`repro_torch.analytics`); each step pulls a bounded-stale
  view, computes gradients, and pushes them compressed through the
  fabric router, the server applying the optimizer; the trainer logs the
  §6 cost model's prediction beside the transport's measured counters.

It runs on the card unless ``device=`` asks for the CPU.  ``init(params=)``
takes a parameter tree (a JAX tree carried across by
``models.convert.params_from_numpy``): torch's generator does not draw
JAX's numbers.
"""
from __future__ import annotations

import os
import re
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch._bits import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import costmodel
from repro_torch.data import SyntheticLM
from repro_torch.models import api
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import make_optimizer


def parse_sync_mode(mode: str):
    """'allreduce' -> ('allreduce', None); 'paramserver' or
    'paramserver(staleness=k)' -> ('paramserver', k or None)."""
    if mode == "allreduce":
        return "allreduce", None
    if mode == "paramserver":
        return "paramserver", None
    m = re.fullmatch(r"paramserver\(staleness=(\d+)\)", mode)
    if m:
        return "paramserver", int(m.group(1))
    raise ValueError(f"unknown sync_mode {mode!r}: want 'allreduce', "
                     f"'paramserver' or 'paramserver(staleness=k)'")


@dataclass
class TrainerConfig:
    steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro-torch-ckpt"))
    global_batch: int = 8
    seq_len: int = 128
    log_every: int = 10
    max_grad_norm: float = 1.0
    microbatches: int = 1
    slow_step_factor: float = 3.0   # watchdog threshold vs trailing mean
    sync_mode: str = "allreduce"    # or "paramserver(staleness=k)"
    ps_staleness: int = 0           # default k if sync_mode carries none
    ps_compress: bool = True        # int8 + error-feedback push path
    ps_block: int = 256             # compression block size


class Trainer:
    """``device``: where parameters, optimizer state and batches live (the
    card unless the caller asks for the CPU)."""

    def __init__(self, cfg, tcfg: TrainerConfig, *, optimizer=None,
                 data=None, device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.opt = optimizer or make_optimizer(cfg.optimizer)
        self.data = data or SyntheticLM(
            vocab_size=cfg.vocab_size, seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch,
            modality=((cfg.num_modality_tokens, cfg.modality_dim)
                      if cfg.modality_dim else None))
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir)
        self.sync_mode, k = parse_sync_mode(tcfg.sync_mode)
        self.ps_staleness = tcfg.ps_staleness if k is None else k
        if self.sync_mode == "paramserver":
            self.step_fn = None
            self.grad_fn = ts.build_grad_step(
                cfg, max_grad_norm=tcfg.max_grad_norm,
                microbatches=tcfg.microbatches)
        else:
            self.step_fn = ts.build_train_step(
                cfg, self.opt, max_grad_norm=tcfg.max_grad_norm,
                microbatches=tcfg.microbatches)
            self.grad_fn = None
        self.ps = None
        self.params = None
        self.opt_state = None
        self.step = 0
        self.step_times = []
        self.metrics_log = []
        self.comm_log = []

    # ----------------------------------------------------------- state --

    def init(self, seed: int = 0, *, params=None):
        """Fresh parameters: ``params`` (a tree on this trainer's device)
        or drawn on the device from ``seed``."""
        if params is None:
            params = api.init_params(
                self.cfg, torch.Generator(self.device).manual_seed(seed),
                device=self.device)
        self.params = params
        self.opt_state = self.opt.init(self.params)
        self.step = 0
        if self.sync_mode == "paramserver":
            self._make_ps()

    def _make_ps(self):
        """(Re)seed the NAM parameter server from self.params; the server
        applies this trainer's optimizer on push."""
        from repro_torch.analytics import ParameterServer
        from repro_torch.fabric import LocalTransport

        def apply(params, grads):
            with torch.no_grad(), \
                    torch.profiler.record_function(ts.OPTIMIZER):
                new_params, self.opt_state = self.opt.update(
                    grads, self.opt_state, params)
            return new_params

        self.ps = None                      # free the old server first
        self.ps = ParameterServer(
            self.params, transport=LocalTransport(device=self.device),
            staleness=self.ps_staleness, compress=self.tcfg.ps_compress,
            block=self.tcfg.ps_block, apply_fn=apply)
        # the server holds the parameters from here on: the trainer's own
        # tree is materialized again only at a checkpoint
        self.params = None

    def _tree(self):
        return {"params": self.params, "opt": self.opt_state}

    def save(self, async_: bool = True):
        if self.ps is not None:
            # materialize the server-side view only at this boundary
            self.params = self.ps.current_params()
        self.ckpt.save(self.step, self._tree(),
                       extra={"data": self.data.state_dict(),
                              "step": self.step}, async_=async_)
        if self.ps is not None:
            self.params = None

    def maybe_restore(self) -> bool:
        if self.ckpt.latest_step() is None:
            return False
        if self.opt_state is None:
            self.init()
        if self.ps is not None:
            self.params = self.ps.current_params()
        tree, manifest = self.ckpt.restore(self._tree())
        self.params, self.opt_state = tree["params"], tree["opt"]
        self.step = int(manifest["extra"]["step"])
        self.data.load_state_dict(manifest["extra"]["data"])
        if self.sync_mode == "paramserver":
            self._make_ps()            # re-seed regions from the restore
        return True

    # ------------------------------------------------------------- run --

    def _batch(self) -> dict:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.data.next_batch().items()}

    def run(self, *, preempt_at: int = None):
        """Train to tcfg.steps.  ``preempt_at`` simulates a node failure
        (raises after that step commits); the caller restarts and
        resumes."""
        if self.opt_state is None and not self.maybe_restore():
            self.init()
        while self.step < self.tcfg.steps:
            self.train_step()
            if self.step % self.tcfg.checkpoint_every == 0:
                self.save(async_=True)
            if preempt_at is not None and self.step >= preempt_at:
                self.ckpt.wait()
                raise RuntimeError(f"simulated preemption at {self.step}")
        self.ckpt.wait()
        self.save(async_=False)
        return self.metrics_log

    def train_step(self) -> float:
        """One step on the next batch (a pull, the gradient and a push in
        paramserver mode; else the optimizer step), timed and logged;
        returns its loss.  :meth:`run` takes these steps and checkpoints
        between them."""
        batch = self._batch()
        t0 = time.perf_counter()
        if self.ps is not None:
            view, _epoch = self.ps.pull()
            grads, m = self.grad_fn(view, batch)
            del view
            self.ps.push(grads)
            del grads
        else:
            self.params, self.opt_state, m = self.step_fn(
                self.params, self.opt_state, batch)
        loss = float(m["loss"])
        dt = time.perf_counter() - t0
        self.step += 1
        self._watchdog(dt)
        if self.step % self.tcfg.log_every == 0:
            self.metrics_log.append((self.step, loss))
            if self.ps is not None:
                self.comm_log.append(self._comm_entry())
        return loss

    def _comm_entry(self) -> dict:
        """§6 comm-cost model prediction next to the fabric transport's
        measured per-verb counters (cumulative), priced on every network
        profile of the paper's 1GbE -> EDR axis."""
        from repro_torch.fabric import netsim

        comp, raw = self.ps.wire_bytes_per_push()
        # modeled fleet size: the JAX package's max(device count, 2), so
        # both packages price the same W on one device
        workers = max(torch.cuda.device_count(), 2)
        predicted = costmodel.t_ps_step(
            raw, self.ps.num_shards, staleness=self.ps.staleness,
            workers=workers, compress_ratio=comp / raw)
        baseline = costmodel.t_allreduce(raw, workers)
        measured = {k: dict(v) for k, v in self.ps.fabric_stats().items()}
        per_profile = {
            name: {
                "t_ps_step_model_s": costmodel.t_ps_step(
                    raw, self.ps.num_shards, prof,
                    staleness=self.ps.staleness, workers=workers,
                    compress_ratio=comp / raw),
                "t_allreduce_model_s": costmodel.t_allreduce(
                    raw, workers, prof),
                "measured_wire_model_s": prof.modeled_time(measured),
            } for name, prof in netsim.PROFILES.items()}
        return {"step": self.step, "t_ps_step_model_s": predicted,
                "t_allreduce_model_s": baseline,
                "push_wire_bytes": comp, "grad_bytes_f32": raw,
                "fabric": measured, "profiles": per_profile}

    def _watchdog(self, dt: float):
        self.step_times.append(dt)
        hist = self.step_times[-20:-1]
        if len(hist) >= 5 and dt > self.tcfg.slow_step_factor * np.mean(hist):
            # in a multi-host deployment this triggers the straggler path
            print(f"[trainer] straggler watchdog: step {self.step} took "
                  f"{dt:.3f}s vs mean {np.mean(hist):.3f}s")
