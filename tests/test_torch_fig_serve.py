"""The port's fig_serve against ``benchmarks/fig_serve.py``, on the CPU.

One configuration (async, ``hot_frac=0.25``) of the short workload is
recorded through both packages' traced transports: the traces are equal
event for event, and so are the store counters and, on every profile, the
re-priced makespan, p50 and p99.  The port's whole figure (six
configurations on the short workload) holds its asserts (a), (b) and (c).
"""
import dataclasses as dc

import jax
import numpy as np
import pytest

from benchmarks import fig_serve as jfs
from repro.configs import get_config as jget, reduce_config as jred
from repro.fabric import netsim as jnetsim
from repro.models import api as japi
from repro_torch.bench import fig_serve as fs
from repro_torch.fabric import netsim


@pytest.fixture(scope="module")
def port_model():
    return fs.model("cpu")


def test_workload_draws_equal_jax():
    for size in (fs.SMALL, fs.FULL):
        args = (size["n"], size["max_arrival"], *size["new"])
        ours, theirs = fs.workload(*args), jfs._workload(*args)
        assert [(a, r, p.tolist(), n) for a, r, p, n in ours] == \
            [(a, r, p.tolist(), n) for a, r, p, n in theirs]


def test_async_trace_and_prices_equal_jax(port_model):
    cfg, params = port_model
    jcfg = jred(jget("glm4-9b"))
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    args = (fs.SMALL["n"], fs.SMALL["max_arrival"], *fs.SMALL["new"])
    theirs = jfs._record(jcfg, jp, jfs._workload(*args), hot_frac=0.25,
                         **fs.SMALL["shape"])
    ours = fs.record(cfg, params, fs.workload(*args), hot_frac=0.25,
                     **fs.SMALL["shape"])
    assert len(ours["trace"]) > 100
    assert [dc.astuple(e) for e in ours["trace"]] == \
        [dc.astuple(e) for e in theirs["trace"]]
    assert ours["compute_seqs"] == theirs["compute_seqs"]
    assert ours["counters"] == theirs["counters"]
    assert ours["counters"]["writebacks"] > 0
    for key in ("rounds", "ticks", "tokens"):
        assert ours[key] == theirs[key], key
    for pname in fs.DEFAULT_PROFILES:
        assert fs.price(ours, netsim.get_profile(pname), window=2) == \
            jfs._price(theirs, jnetsim.get_profile(pname), window=2)


def test_figure_asserts_hold():
    rows, extras = fs.run(small=True, device="cpu")
    assert extras["parity"] and extras["device"] == "cpu"
    assert set(extras["configs"]) == {"all_local", "hot0.25",
                                      "hot0.25_blocking", "all_cold"}
    for pname in fs.DEFAULT_PROFILES:
        rec = extras["recovery"][pname]
        assert rec["ratio"] >= 2.0
        lat = extras["latency"][pname]
        assert lat["hot0.25"]["p99_s"] < lat["hot0.25_blocking"]["p99_s"]
    assert len(rows) == len(fs.DEFAULT_PROFILES) * 5
    local = extras["configs"]["all_local"]["counters"]
    assert local["misses"] == 0 and local["writebacks"] == 0
    assert np.isfinite([r[1] for r in rows]).all()
