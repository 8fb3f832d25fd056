"""Quickstart: build a reduced arch, run a forward pass, one train step, a
few decode steps; the paper's database side through the ``repro_torch.db``
facade (a transaction and a cost-planned query); and the §6 parameter
server (a bounded-stale pull and a compressed push).  A twin of
``examples/quickstart.py``.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--arch glm4-9b] [--device cpu]

Weights are drawn on the device from seed 0; tokens and the query's S
keys are drawn with numpy from the seeds the JAX example gives
``jax.random`` (1 and 7).  The demos take their inputs as arguments.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch._bits import np_u32, resolve_device
from repro_torch.analytics import ParameterServer
from repro_torch.configs import get_config, reduce_config
from repro_torch.db import Database
from repro_torch.fabric import LocalTransport
from repro_torch.models import api
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import build_train_step
from repro_torch.tree import leaves, tree_map

JOIN_ROWS = 4096


def s_keys() -> np.ndarray:
    """The query's S keys: JOIN_ROWS u32 keys uniform in [1, 2 JOIN_ROWS),
    from seed 7."""
    n = JOIN_ROWS
    return np.random.default_rng(7).integers(1, 2 * n, n).astype(np.uint32)


def nam_db_demo(keys=None, *, device=None) -> dict:
    """The NAM-DB facade in ten lines: one transaction, one planned query
    (R = 1..n of value 3 joined with S = ``keys`` of value 2)."""
    db = Database(device=device)
    accounts = db.create_table("accounts", 256, payload_words=1)
    accounts.seed(np.arange(8), np.full((8, 1), 100))
    with db.session() as s:                       # begin() via __enter__
        pay, rids, _ = s.get(accounts, [0, 1])
        s.put(accounts, [0, 1], np_u32(pay) + 25, read_cids=rids)
    print(f"db: txn committed={s.committed} cid={s.cid}")

    keys = s_keys() if keys is None else np.asarray(keys, np.uint32)
    n = keys.shape[0]
    db.load_table("R", np.arange(1, n + 1, dtype=np.uint32),
                  np.full((n,), 3, np.uint32))
    db.load_table("S", keys, np.full((n,), 2, np.uint32))
    q = db.scan("R").join(db.scan("S").filter(sel=0.5)).aggregate()
    ex = db.explain(q)                            # costed alternatives
    res = db.execute(q)                           # planner's argmin choice
    value = int(np_u32(res.value))
    print(f"db: planner chose {ex.chosen} -> join aggregate "
          f"{value} ({len(ex.alternatives)} costed alternatives)")
    return {"committed": bool(s.committed), "cid": s.cid,
            "chosen": ex.chosen, "aggregate": value,
            "alternatives": len(ex.alternatives)}


def param_server_demo(params, *, device=None) -> dict:
    """§6 in five lines: the model in NAM regions, a bounded-stale pull,
    a compressed push through the fabric router."""
    ps = ParameterServer(params, staleness=2,
                         transport=LocalTransport(device=device))
    view, epoch = ps.pull(worker=0)            # one-sided READ (cached ok)
    grads = tree_map(lambda p: 0.01 * torch.ones_like(p), view)
    ps.push(grads, worker=0)                   # int8+EF push via route()
    comp, raw = ps.wire_bytes_per_push()
    print(f"ps: epoch {epoch}->{ps.epoch}, push wire {comp:,}B "
          f"(f32 {raw:,}B) over {ps.num_shards} shards")
    return {"epoch_before": epoch, "epoch_after": ps.epoch,
            "push_bytes": comp, "push_bytes_f32": raw,
            "shards": ps.num_shards}


def lm_demo(cfg, params, tokens, *, device) -> dict:
    """A forward pass, one train step and 5 greedy decode steps of the
    (B, S) numpy ``tokens``; the train step updates ``params`` in place of
    the returned tree."""
    out = {}
    batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int64,
                                       device=device)}
    batch["labels"] = batch["tokens"]
    B = tokens.shape[0]
    if cfg.modality_dim:
        batch["modality"] = torch.ones(
            (B, cfg.num_modality_tokens, cfg.modality_dim),
            dtype=torch.float32, device=device)
    with torch.no_grad():
        logits, _ = api.forward(cfg, params, batch["tokens"],
                                modality=batch.get("modality"))
    print(f"forward: logits {tuple(logits.shape)}")
    out["logits_shape"] = list(logits.shape)

    opt = make_optimizer(cfg.optimizer)
    step = build_train_step(cfg, opt)
    params, _, m = step(params, opt.init(params), batch)
    out["loss"], out["grad_norm"] = float(m["loss"]), float(m["grad_norm"])
    print(f"train step: loss={out['loss']:.4f} "
          f"gnorm={out['grad_norm']:.4f}")

    with torch.no_grad():
        state = api.init_decode_state(cfg, params, B, 32,
                                      modality=batch.get("modality"))
        tok = batch["tokens"][:, :1]
        for _ in range(5):
            logits, state = api.decode_step(cfg, params, state, tok)
            tok = torch.argmax(logits, dim=-1)
    out["decoded"] = tok[:, 0].tolist()
    print(f"decode: 5 tokens, last={out['decoded']}")
    return out, params


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduce_config(get_config(args.arch))
    print(f"arch={cfg.name} family={cfg.family}")
    params = api.init_params(cfg, torch.Generator(dev).manual_seed(0),
                             device=dev)
    n = sum(x.numel() for x in leaves(params))
    print(f"params: {n:,}")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 64))
    out, params = lm_demo(cfg, params, tokens, device=dev)
    return {"arch": cfg.name, "params": n, **out,
            "db": nam_db_demo(device=dev),
            "ps": param_server_demo(params, device=dev)}


if __name__ == "__main__":
    main()
