"""Fig 9 in the port (``repro_torch.bench.fig9_ml``) against the JAX
benchmark (``benchmarks/fig9_ml.py``) on the same parameter and gradient
arrays: every row (the virtual wall-clocks, push and pull bytes, the
cost-model rows) and the extras (wall-clocks, per-mode fabric counters,
model terms, gradient bytes) are equal.

The JAX benchmark's ``_delta`` subtracts every counter of a verb,
including the ``queue_hist`` histogram (a dict), and raises TypeError on
the first step; the test runs it with ``_delta`` over the numeric
counters, which is all its wire pricing reads (``modeled_time`` reads
calls, msgs and bytes)."""
import jax
import numpy as np
import pytest

from benchmarks import fig9_ml as jfig9
from repro_torch.bench import fig9_ml


def _numeric_delta(transport, before):
    out = {}
    for verb, s in transport.stats().items():
        b = before.get(verb, {})
        d = {k: v - b.get(k, 0) for k, v in s.items()
             if isinstance(v, (int, float))}
        if any(d.values()):
            out[verb] = d
    return out


@pytest.fixture(scope="module")
def both():
    mp = pytest.MonkeyPatch()
    mp.setattr(jfig9, "_delta", _numeric_delta)
    try:
        jrows, jx = jfig9.run()
        params = jax.tree.map(np.asarray, jfig9._params())
        grads = {t: jax.tree.map(np.asarray, jfig9._grad(t))
                 for t in range(jfig9.TOTAL_BATCHES)}
    finally:
        mp.undo()
    trows, tx = fig9_ml.run(device="cpu", params=params,
                            grad=grads.__getitem__, timed=True)
    return jrows, jx, trows, tx


def test_rows_equal_jax(both):
    jrows, _, trows, _ = both
    assert [r[0] for r in trows] == [r[0] for r in jrows]
    assert trows == jrows


def test_extras_equal_jax(both):
    _, jx, _, tx = both
    for key in ("wallclock_s", "fabric", "sync_fabric", "model",
                "grad_bytes_f32", "grad_bytes_compressed", "workers",
                "straggler_factor", "total_batches", "profile"):
        assert tx[key] == jx[key], key


def test_ps_beats_sync_and_staleness_saves_pull_bytes(both):
    """The figure's claim, on the port's rows."""
    _, _, trows, tx = both
    rows = {name: val for name, val, _ in trows}
    w = tx["wallclock_s"]
    assert w["ps_k0"] < w["sync"] and w["ps_k8"] < w["sync"]
    assert rows["fig9/ps_k8_pull_bytes"] < rows["fig9/ps_k0_pull_bytes"]
    assert tx["measured_s"]["fig9/ps_pull_push_round"] > 0
    assert tx["device"] == "cpu"


def test_default_draws_run_the_same_counters():
    """The port's own numpy draws give the same counters (they depend on
    shapes and the schedule, not on values)."""
    rows, _ = fig9_ml.run(device="cpu")
    assert rows[2] == ("fig9/ps_k0_push_bytes", 849408.0,
                       "compressed_vs_f32_3158016")
