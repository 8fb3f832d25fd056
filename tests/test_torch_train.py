"""The port's training path against the JAX package, on the CPU, at small
sizes (the reduced mamba2-370m, and the tiny dense model of
``tests/test_analytics.py:204``):

* optimizer updates (AdamW, Adafactor, the warmup-cosine schedule,
  global-norm clipping) within rtol 1e-6 (the same f32 operations; a
  power or square root may round one ulp apart);
* ``loss_fn`` and its gradients against ``jax.value_and_grad`` of JAX's
  ``loss_fn`` on the same parameters and batch, with both packages'
  ``ACT_DTYPE`` set to float32 by the test: loss within rtol 1e-5, every
  gradient leaf within rms(diff) <= 1e-4 rms(JAX) (the same arithmetic,
  JAX's chunked attention and SSD, in another order of f32 additions);
* the ported chunked SSD (``ssm.ssd_chunked_plain``) against JAX's
  ``ssd_chunked``, values and gradients within rtol 1e-5 / atol 1e-5;
* each ``autograd.Function`` of ``kernels.ops`` with its forward swapped
  for the plain version: its gradients equal the plain path's autograd,
  alone and inside the whole model's loss (remat on);
* ``SyntheticLM`` batches bit-equal to JAX's across a resume;
* a checkpoint written by JAX's ``CheckpointManager`` restores in the
  port bit for bit, and the reverse;
* the trainer: allreduce against raw ``paramserver(staleness=0)`` within
  rtol 1e-4 (port only, as ``tests/test_analytics.py:223``); the port's
  loss log against JAX's trainer on the same parameters for that config
  and the stale compressed one (``:251``), within rtol 1e-4; a
  preemption restart resumes (``tests/test_system.py:36``) and ends with
  the losses of an uninterrupted run.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.lm as jlm
from repro.checkpoint import CheckpointManager as JCkpt
from repro.configs import get_config as jget, reduce_config as jred
from repro.configs.base import ModelConfig as JModelConfig
from repro.data import SyntheticLM as JSynthetic
from repro.models import api as japi
from repro.models import ssm as jssm
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import SyntheticLM
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.models import api, attention, lm, ssm
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as ts
from repro_torch.train.trainer import Trainer, TrainerConfig, parse_sync_mode
from repro_torch.tree import leaves, tree_flatten


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(jlm, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(lm, "ACT_DTYPE", torch.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.sqrt(np.mean((got - want) ** 2)) / max(
        np.sqrt(np.mean(want ** 2)), 1e-30)


def _assert_tree_close(t_tree, j_tree, rtol, atol):
    flat_t, _ = tree_flatten(t_tree)
    flat_j = jax.tree.leaves(j_tree)
    assert len(flat_t) == len(flat_j)
    for a, b in zip(flat_t, flat_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=rtol, atol=atol)


def _tiny_cfg(mod):
    kw = dict(name="tiny-ps", family="dense", num_layers=1, d_model=32,
              num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=128,
              head_dim=16, tie_embeddings=True)
    return (JModelConfig if mod == "jax" else ModelConfig)(**kw)


def _cfgs(name):
    if name == "tiny":
        return _tiny_cfg("jax"), _tiny_cfg("torch")
    return jred(jget(name)), reduce_config(get_config(name))


def _batch(cfg, batch, seq, step=0):
    d = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                    global_batch=batch)
    d.step = step
    return d.next_batch()


# -------------------------------------------------------------- optimizer --

def _tt(tree):
    """A nested dict of numpy arrays as tensors."""
    if isinstance(tree, dict):
        return {k: _tt(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((3, 5, 4)).astype(np.float32),
                  "b": rng.standard_normal((4,)).astype(np.float32)},
            "emb": rng.standard_normal((6, 8)).astype(np.float32)}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_jax(name):
    jo = jopt.make_optimizer(name, lr=1e-2)
    to = topt.make_optimizer(name, lr=1e-2)
    p = _opt_tree(0)
    jp, tp = jax.tree.map(jnp.asarray, p), _tt(p)
    js, tstate = jo.init(jp), to.init(tp)
    for i in range(3):
        g = _opt_tree(10 + i)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, tstate = to.update(_tt(g), tstate, tp)
    _assert_tree_close(tp, jp, 1e-6, 1e-7)
    _assert_tree_close(tstate, js, 1e-6, 1e-7)
    assert int(tstate["count"]) == 3 and tstate["count"].dtype == torch.int32


def test_schedule_and_clip_match_jax():
    for step in (1, 50, 200, 201, 5000, 10_000, 12_000):
        np.testing.assert_allclose(
            float(topt.warmup_cosine(torch.tensor(step), 3e-4)),
            float(jopt.warmup_cosine(jnp.asarray(step), 3e-4)), rtol=1e-6)
    g = _opt_tree(3)
    for max_norm in (0.5, 100.0):
        jg, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                          max_norm)
        tg, tn = topt.clip_by_global_norm(_tt(g), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _assert_tree_close(tg, jg, 1e-6, 1e-7)


# ------------------------------------------------------ loss and gradients --

@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch,seq", [("tiny", 16), ("mamba2-370m", 64)])
def test_loss_and_grads_match_jax(f32, arch, seq, microbatches):
    jcfg, cfg = _cfgs(arch)
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, _np(jp), device="cpu")
    b = _batch(cfg, 4, seq)
    jl, jg = jax.jit(lambda p, bb: jts._loss_and_grads(
        jcfg, p, bb, microbatches))(jp, b)
    tl, tg = ts._loss_and_grads(cfg, tp, {k: torch.from_numpy(v)
                                          for k, v in b.items()},
                                microbatches)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    flat_t, flat_j = leaves(tg), jax.tree.leaves(jg)
    assert len(flat_t) == len(flat_j)
    for a, j in zip(flat_t, flat_j):
        assert a.shape == j.shape
        assert _rel_rms(a.numpy(), j) <= 1e-4


def test_chunked_ce_equals_full_ce(monkeypatch, f32):
    jcfg, cfg = _cfgs("tiny")
    tp = params_from_numpy(cfg, _np(japi.init_params(jcfg,
                                                     jax.random.PRNGKey(0))),
                           device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 32).items()}
    full = api.loss_fn(cfg, tp, b)
    monkeypatch.setattr(lm, "CE_CHUNK", 8)
    np.testing.assert_allclose(float(api.loss_fn(cfg, tp, b)), float(full),
                               rtol=1e-6)


def _ssd_inputs(seed, B=2, S=64, H=3, P=8, N=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, P)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            (rng.random((B, S, H)) * 0.2).astype(np.float32),
            -rng.random(H).astype(np.float32) - 0.1)


def test_chunked_ssd_matches_jax_values_and_grads():
    xs = _ssd_inputs(0)
    w = np.random.default_rng(9).standard_normal(xs[0].shape).astype(
        np.float32)

    def jf(*a):
        y, st = jssm.ssd_chunked(*a, 16)
        return jnp.sum(y * w) + jnp.sum(st), (y, st)

    (_, (jy, jst)), jg = jax.value_and_grad(jf, argnums=range(5),
                                            has_aux=True)(
        *map(jnp.asarray, xs))
    tx = [torch.from_numpy(x).requires_grad_() for x in xs]
    ty, tst = ssm.ssd_chunked_plain(*tx, 16)
    (ty * torch.from_numpy(w)).sum().add(tst.sum()).backward()
    np.testing.assert_allclose(ty.detach().numpy(), jy, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tst.detach().numpy(), jst, rtol=1e-5,
                               atol=1e-5)
    for t, j in zip(tx, jg):
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssm.ssd_chunked_plain(*tx, 24)


def test_chunked_ssd_gradient_finite_where_decay_overflows():
    """Over a chunk whose decay passes e^88 (here dt * |A| = 2 a step over
    64 steps; mamba2-370m's initial parameters reach it over 256), JAX's
    gradient is NaN (exp of the masked half overflows, and its gradient is
    0 * inf); the port masks before exp: the same values, finite
    gradients."""
    x, b, c, dt, a = _ssd_inputs(2)
    dt = np.full_like(dt, 2.0)
    a = np.full_like(a, -1.0)

    def jf(*args):
        return jnp.sum(jssm.ssd_chunked(*args, 64)[0])

    jg = jax.grad(jf, argnums=(0, 3))(*map(jnp.asarray, (x, b, c, dt, a)))
    assert not np.isfinite(np.asarray(jg[1])).all()
    tx = [torch.from_numpy(v).requires_grad_() for v in (x, b, c, dt, a)]
    ty, _ = ssm.ssd_chunked_plain(*tx, 64)
    ty.sum().backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in tx)
    np.testing.assert_allclose(
        ty.detach().numpy(),
        np.asarray(jssm.ssd_chunked(*map(jnp.asarray, (x, b, c, dt, a)),
                                    64)[0]), rtol=1e-5, atol=1e-5)


# -------------------------------------------------- the autograd Functions --

@pytest.fixture
def plain_forward(monkeypatch):
    """The kernel path on the CPU: the wrappers' forwards swapped for the
    plain versions and ``impl=None`` resolving to "kernel"."""
    monkeypatch.setattr(kfa, "flash_attention", ref.flash_attention)
    monkeypatch.setattr(kssd, "ssd_scan", ref.ssd_scan)
    monkeypatch.setattr(ops, "resolve_impl",
                        lambda t, impl=None: impl or "kernel")


def test_functions_give_the_plain_gradients(plain_forward):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 64, 4, 16, generator=g, requires_grad=True)
    k = torch.randn(2, 64, 2, 16, generator=g, requires_grad=True)
    v = torch.randn(2, 64, 2, 16, generator=g, requires_grad=True)
    out = ops.flash_attention(q, k, v, backward=attention._flat_chunked_attend)
    assert "FlashAttentionFn" in type(out.grad_fn).__name__
    go = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad(out, (q, k, v), go)
    want = torch.autograd.grad(ref.flash_attention(q, k, v), (q, k, v), go)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    xs = [torch.from_numpy(x).requires_grad_() for x in _ssd_inputs(1)]
    y, st = ops.ssd_scan(*xs, backward=lambda *a: ssm.ssd_chunked_plain(
        *a[:5], 16, a[5]))
    assert "SSDScanFn" in type(y.grad_fn).__name__ and not st.requires_grad
    gy = torch.randn(y.shape, generator=g)
    got = torch.autograd.grad(y, xs, gy)
    want = torch.autograd.grad(ref.ssd_scan(*xs)[0], xs, gy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="backward="):
        ops.ssd_scan(*xs)


@pytest.mark.parametrize("arch,seq", [("glm4-9b", 32), ("mamba2-370m", 64)])
def test_model_gradients_through_the_functions(f32, monkeypatch, arch, seq):
    """The whole loss with remat on: gradients through the Functions equal
    the plain path's."""
    _, cfg = _cfgs(arch)
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, seq).items()}
    pl, pg = ts._loss_and_grads(cfg, params, b, 1)
    monkeypatch.setattr(kfa, "flash_attention", ref.flash_attention)
    monkeypatch.setattr(kssd, "ssd_scan", ref.ssd_scan)
    monkeypatch.setattr(ops, "resolve_impl",
                        lambda t, impl=None: impl or "kernel")
    seen = []
    for name in ("FlashAttentionFn", "SSDScanFn"):
        fn = getattr(ops, name)
        orig = fn.backward
        monkeypatch.setattr(fn, "backward", staticmethod(
            lambda ctx, *g, _o=orig, _n=name: (seen.append(_n), _o(ctx, *g))[1]))
    kl, kg = ts._loss_and_grads(cfg, params, b, 1)
    assert seen and len(set(seen)) == 1
    np.testing.assert_allclose(float(kl), float(pl), rtol=1e-6)
    for a, p in zip(leaves(kg), leaves(pg)):
        assert _rel_rms(a.numpy(), p.numpy()) <= 1e-5


# ----------------------------------------------------------------- data ----

def test_synthetic_batches_bit_equal_across_resume():
    kw = dict(vocab_size=100, seq_len=16, global_batch=8)
    j, t = JSynthetic(**kw), SyntheticLM(**kw)
    for _ in range(3):
        jb, tb = j.next_batch(), t.next_batch()
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
    r = SyntheticLM(**kw)
    r.load_state_dict(j.state_dict())            # resume after 3 batches
    jb = j.next_batch()
    for k, v in r.next_batch(slow_worker=0).items():
        np.testing.assert_array_equal(v, jb[k])
    m = dict(kw, modality=(2, 3))
    np.testing.assert_array_equal(SyntheticLM(**m).next_batch()["modality"],
                                  JSynthetic(**m).next_batch()["modality"])


# ----------------------------------------------------------- checkpoints ---

def test_checkpoints_cross_restore(tmp_path):
    jcfg, cfg = _cfgs("mamba2-370m")
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    jo = jopt.make_adamw()
    jstate = jo.update(jax.tree.map(lambda x: x * 0.01, jp), jo.init(jp),
                       jp)[1]
    jtree = {"params": jp, "opt": jstate}
    JCkpt(str(tmp_path / "j")).save(7, jtree, extra={"step": 7})
    like = {"params": api.init_params(cfg, device="cpu"),
            "opt": topt.make_adamw().init(api.init_params(cfg,
                                                          device="cpu"))}
    got, manifest = CheckpointManager(str(tmp_path / "j")).restore(like)
    assert manifest["extra"] == {"step": 7}
    flat_t, flat_j = leaves(got), jax.tree.leaves(jtree)
    assert len(flat_t) == len(flat_j)
    for a, b in zip(flat_t, flat_j):
        assert a.dtype == torch.from_numpy(np.asarray(b)).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # and back: the port's save restores in JAX
    mgr = CheckpointManager(str(tmp_path / "t"))
    mgr.save(9, got, extra={"step": 9}, async_=True)
    mgr.wait()
    assert sorted(os.listdir(tmp_path / "t")) == ["step-0000000009"]
    back, m2 = JCkpt(str(tmp_path / "t")).restore(jtree)
    assert m2["step"] == 9
    for a, b in zip(jax.tree.leaves(back), flat_j):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------------------- trainer ---

def test_sync_mode_parsing():
    assert parse_sync_mode("allreduce") == ("allreduce", None)
    assert parse_sync_mode("paramserver") == ("paramserver", None)
    assert parse_sync_mode("paramserver(staleness=4)") == ("paramserver", 4)
    for bad in ("paramserver(staleness=-1)", "ring"):
        with pytest.raises(ValueError):
            parse_sync_mode(bad)


def _trainers(tmp_path, mode, *, steps, compress, lr, log_every=2):
    """JAX's trainer and the port's on JAX's initial parameters."""
    jcfg, cfg = _cfgs("tiny")
    kw = dict(steps=steps, global_batch=2, seq_len=16, log_every=log_every,
              checkpoint_every=100, sync_mode=mode, ps_compress=compress)
    jt = JTrainer(jcfg, JTrainerConfig(
        checkpoint_dir=str(tmp_path / "j"), **kw),
        optimizer=jopt.make_adamw(lr=lr, schedule=lambda s, lr: lr))
    jt.init()
    tt = Trainer(cfg, TrainerConfig(checkpoint_dir=str(tmp_path / "t"),
                                    **kw),
                 optimizer=topt.make_adamw(lr=lr, schedule=lambda s, lr: lr),
                 device="cpu")
    tt.init(params=params_from_numpy(cfg, _np(jt.params), device="cpu"))
    return jt, tt


def test_trainer_paramserver_matches_allreduce(tmp_path, f32):
    logs = {}
    for mode in ("allreduce", "paramserver(staleness=0)"):
        _, tt = _trainers(tmp_path / mode[:6], mode, steps=6, compress=False,
                          lr=1e-3)
        logs[mode] = np.array([l for _, l in tt.run()])
        if mode.startswith("paramserver"):
            assert tt.ps is not None and tt.ps.epoch == 6
            entry = tt.comm_log[-1]
            assert entry["fabric"]["route"]["bytes"] > 0
            assert entry["t_ps_step_model_s"] > 0
    np.testing.assert_allclose(logs["allreduce"],
                               logs["paramserver(staleness=0)"], rtol=1e-4)


@pytest.mark.parametrize("mode,compress,steps,lr", [
    ("paramserver(staleness=0)", False, 6, 1e-3),
    ("paramserver(staleness=3)", True, 12, 5e-3),
    ("allreduce", True, 6, 1e-3)])
def test_trainer_loss_log_matches_jax(tmp_path, f32, mode, compress, steps,
                                      lr):
    """The same parameters, batches and optimizer give JAX's loss log; in
    paramserver mode also its comm log (model terms and counters)."""
    jt, tt = _trainers(tmp_path, mode, steps=steps, compress=compress, lr=lr,
                       log_every=1 if compress else 2)
    jlog, tlog = jt.run(), tt.run()
    assert [s for s, _ in tlog] == [s for s, _ in jlog]
    np.testing.assert_allclose([l for _, l in tlog], [l for _, l in jlog],
                               rtol=1e-4)
    if jt.ps is not None:
        assert tt.ps.epoch == jt.ps.epoch == steps
        je, te = jt.comm_log[-1], tt.comm_log[-1]
        for key in ("push_wire_bytes", "grad_bytes_f32", "fabric",
                    "t_ps_step_model_s", "t_allreduce_model_s", "profiles"):
            assert te[key] == je[key], key


def test_preemption_restart_resumes(tmp_path):
    cfg = reduce_config(get_config("glm4-9b"))
    tcfg = TrainerConfig(steps=20, global_batch=4, seq_len=32,
                         checkpoint_dir=str(tmp_path / "ck"),
                         checkpoint_every=5, log_every=5)
    tr = Trainer(cfg, tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="preemption"):
        tr.run(preempt_at=11)
    tr2 = Trainer(cfg, tcfg, device="cpu")
    assert tr2.maybe_restore()
    assert tr2.step == 10 and tr2.data.step == 10
    log = tr2.run()
    assert tr2.step == 20
    straight = Trainer(cfg, TrainerConfig(
        steps=20, global_batch=4, seq_len=32, log_every=5,
        checkpoint_every=100, checkpoint_dir=str(tmp_path / "ck3")),
        device="cpu").run()
    assert log == straight[2:]
