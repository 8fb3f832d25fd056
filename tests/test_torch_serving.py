"""The port's dense ServeEngine against the JAX engine, on the CPU.

* Same requests, same weights (JAX's, carried by ``params_from_numpy``):
  with both packages' ``ACT_DTYPE`` set to float32 by the test, the
  engines' tokens are equal, token for token; the slot lock words end at
  0 and the CAS and WRITE message counters of the two databases are
  equal.  In bf16 the decode logits along the engine's token stream
  differ from JAX's by no more than twice JAX's own bf16 error (its bf16
  logits against its f32 ones), as in tests/test_torch_models.py.
* The prefill step's tokens equal JAX's ``build_prefill_step``'s (f32).
* The paged engine's tokens equal the JAX paged engine's (f32), and
  mamba2 refuses paged mode as JAX does; the launcher runs on the CPU;
  the card's serve runner (``repro_torch.bench.serve``) rehearses at a
  small size, and its layer check reads above ``chip_smoke.ROW_TOL`` when
  the plain path has the faults of ``chip_smoke``'s controls.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.lm as jlm
from repro.configs import get_config as jget, reduce_config as jred
from repro.models import api as japi
from repro.serving import Request as JRequest, ServeEngine as JEngine
from repro.train.train_step import build_prefill_step as j_prefill_step
from repro_torch.bench import serve as bench_serve
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import ops
from repro_torch.models import api, lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import Request, ServeEngine
from repro_torch.train.train_step import build_prefill_step

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["glm4-9b", "mamba2-370m"]
ACT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    jcfg, cfg = jred(jget(arch)), reduce_config(get_config(arch))
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


def _act(mp, name):
    mp.setattr(jlm, "ACT_DTYPE", ACT[name][0])
    mp.setattr(lm, "ACT_DTYPE", ACT[name][1])


def _waves(n_waves=2, slots=4, seed=1):
    rng = np.random.default_rng(seed)
    return [[(slots * w + i,
              rng.integers(0, 256, int(rng.integers(2, 9))).astype(np.int32),
              int(rng.integers(3, 7))) for i in range(slots)]
            for w in range(n_waves)]


def test_engine_tokens_equal_jax_f32(models, monkeypatch):
    jcfg, cfg, jp, tp = models
    _act(monkeypatch, "f32")
    # a config object of its own: the JAX engine caches its jitted decode
    # step per config object, and this one must be traced in f32
    jcfg = dataclasses.replace(jcfg)
    je = JEngine(jcfg, jp, slots=4, max_seq=64)
    te = ServeEngine(cfg, tp, slots=4, max_seq=64, device="cpu")
    jout, tout = {}, {}
    for wave in _waves():
        for r in je.run([JRequest(rid=i, prompt=p, max_new_tokens=m)
                         for i, p, m in wave]):
            jout[r.rid] = r.out
        for r in te.run([Request(rid=i, prompt=p, max_new_tokens=m)
                         for i, p, m in wave]):
            tout[r.rid] = r.out
    assert len(tout) == 8 and tout == jout
    assert not bool(te.slot_words.any())
    assert not np.asarray(je.slot_words).any()
    jstats = je.db.transport.stats()
    tstats = te.db.transport.stats()
    for verb in ("cas", "write"):
        for key in ("calls", "msgs", "bytes"):
            assert tstats[verb][key] == jstats[verb][key], (verb, key)


def test_engine_stream_bf16_logits_within_tolerance(models, monkeypatch):
    """The engine's first wave as decode steps (prompts fed token by token,
    shorter ones padded with 0), logits compared step by step."""
    jcfg, cfg, jp, tp = models
    wave = _waves(n_waves=1)[0]
    steps = max(len(p) for _, p, _ in wave)
    toks = np.zeros((steps, 4, 1), np.int32)
    for s, (_, p, _) in enumerate(wave):
        toks[:len(p), s, 0] = p

    def run(name):
        _act(monkeypatch, name)
        js = japi.init_decode_state(jcfg, jp, 4, 32)
        ts = api.init_decode_state(cfg, tp, 4, 32)
        jstep = jax.jit(lambda p, s, t: japi.decode_step(jcfg, p, s, t))
        out = []
        for t in range(steps):
            a, js = jstep(jp, js, jnp.asarray(toks[t]))
            b, ts = api.decode_step(cfg, tp, ts,
                                    torch.from_numpy(toks[t]).long())
            out.append((np.asarray(a, np.float32), b.float().numpy()))
        return out
    ref32 = [a for a, _ in run("f32")]
    for (jl, tl), j32 in zip(run("bf16"), ref32):
        assert np.isfinite(tl).all()
        assert np.abs(tl - jl).max() <= 2 * np.abs(jl - j32).max()


def test_prefill_step_matches_jax_f32(models, monkeypatch):
    jcfg, cfg, jp, tp = models
    _act(monkeypatch, "f32")
    toks = np.random.default_rng(3).integers(0, 256, (3, 64)).astype(
        np.int32)
    want = j_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    got = build_prefill_step(cfg)(tp, {"tokens": torch.from_numpy(toks)
                                       .long()})
    assert got.shape == (3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paged_mode_not_ported(models, monkeypatch):
    """Paged mode is ported: glm4's paged engine (2 slots, 4 resident, a
    2-block hot tier) decodes the JAX paged engine's tokens in f32 and
    frees its slot locks; mamba2, with no sequence leaf to page, raises
    JAX's ValueError in both packages."""
    jcfg, cfg, jp, tp = models
    _act(monkeypatch, "f32")
    jcfg = dataclasses.replace(jcfg)
    kw = dict(slots=2, max_seq=64, paged=True, block_tokens=8,
              max_resident=4, hot_blocks=2)
    reqs = _waves(n_waves=1, slots=6)[0]
    if cfg.family == "ssm":
        with pytest.raises(ValueError, match="seq-axis leaf"):
            JEngine(jcfg, jp, **kw)
        with pytest.raises(ValueError, match="seq-axis leaf"):
            ServeEngine(cfg, tp, device="cpu", **kw)
        return
    je = JEngine(jcfg, jp, **kw)
    te = ServeEngine(cfg, tp, device="cpu", **kw)
    jout = {r.rid: r.out for r in je.run(
        [JRequest(rid=i, prompt=p, max_new_tokens=m) for i, p, m in reqs])}
    tout = {r.rid: r.out for r in te.run(
        [Request(rid=i, prompt=p, max_new_tokens=m) for i, p, m in reqs])}
    assert len(tout) == 6 and tout == jout
    assert te.store.counters == je.store.counters
    assert not bool(te.slot_words.any())


def test_engine_refuses_parameters_elsewhere(models):
    _, cfg, _, tp = models
    with pytest.raises(ValueError, match="parameters on cpu"):
        ServeEngine(cfg, tp, device="meta")


def test_launch_serve_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "glm4-9b", "--smoke", "--device", "cpu", "--requests", "3",
         "--slots", "2", "--max-new", "3"],
        capture_output=True, text=True, env=env, timeout=300, check=True)
    assert "[serve] completed 3 requests" in out.stdout
    assert out.stdout.count("-> out=") == 3


def test_serve_runner_rehearses_on_cpu():
    """The card's serve runner at a small size: the CPU launches no kernel,
    the plain engine gives the same tokens, the locks end free."""
    cfg = reduce_config(get_config("mamba2-370m"))
    params = bench_serve.weights(cfg, device="cpu")
    pre = bench_serve.prefill(cfg, params, batch=2, seq=32, iters=1,
                              profiled=False)
    assert pre["full"]["finite"] and pre["full"]["step_agrees"]
    assert pre["full"]["max_abs_diff"] == 0.0      # both plain on the CPU
    assert not any(pre["launches"][0].values())
    a = bench_serve.engine(cfg, params, slots=4, max_seq=128, n=6,
                           max_new=3)
    b = bench_serve.engine(cfg, params, slots=4, max_seq=128, n=6,
                           max_new=3, impl="plain")
    assert a["outs"] == b["outs"] and len(a["outs"]) == 6
    assert a["lock_words_zero"] and [w["requests"] for w in a["waves"]] == \
        [4, 2]
    tokens = bench_serve.prompt(cfg, 2, 32, torch.device("cpu"))
    layers = bench_serve.layer_check(cfg, params, tokens)
    assert layers["per_layer"] == [0.0] * cfg.num_layers  # both plain here
    f32 = bench_serve.f32_witness(cfg, batch=2, seq=32, device="cpu")
    assert f32["kernel"]["max_abs_diff"] == 0.0
    assert f32["kernel"]["argmax_agree"] == 1.0
    assert 0.0 < f32["nudged"]["max_abs_diff"] < 1e-3
    assert lm.ACT_DTYPE == torch.bfloat16               # restored
    assert not any(ops.launch_counts().values())


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,kernel", [("glm4-9b", "flash_attention"),
                                         ("mamba2-370m", "ssd_scan")])
def test_layer_check_sees_a_faulty_plain_path(arch, kernel):
    """chip_smoke's control: with one key tile dropped from the plain
    attention, or the SSM state not carried across the middle chunk
    boundary, the serve runner's layer check reads above ROW_TOL on the
    first layer, where the sound paths read 0 on the CPU; the layer check
    leaves ops as it found it."""
    smoke = _chip_smoke()
    cfg = reduce_config(get_config(arch))
    params = bench_serve.weights(cfg, device="cpu")
    tokens = bench_serve.prompt(cfg, 2, 512, torch.device("cpu"))
    assert bench_serve.layer_check(cfg, params, tokens, groups=1)["max"] \
        == 0.0
    with smoke.faulty_plain(kernel):
        control = bench_serve.layer_check(cfg, params, tokens, groups=1)
    assert control["max"] > smoke.ROW_TOL
    assert ops.flash_attention.__module__ == ops.__name__
    assert ops.ssd_scan.__module__ == ops.__name__
    assert bench_serve.layer_check(cfg, params, tokens, groups=1)["max"] \
        == 0.0                                           # restored


def test_row_rel_err_reads_rows_on_their_own_scale():
    """A difference of 1 % of a row's rms reads 0.01 in a row of small
    values as in a row of large ones; the worst row is reported."""
    want = torch.tensor([[100.0, -100.0], [0.01, -0.01]])
    got = want.clone()
    got[1] += 1e-4
    assert bench_serve.row_rel_err(got, want) == pytest.approx(1e-2, rel=1e-3)
    got[0] += 10.0
    assert bench_serve.row_rel_err(got, want) == pytest.approx(0.1, rel=1e-3)
