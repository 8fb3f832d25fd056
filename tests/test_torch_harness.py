"""The port's benchmark harness (``repro_torch.bench.run``) against the JAX
harness (``benchmarks/run.py``), on the CPU:

  * the registry holds the nine figures in the JAX harness's order;
    ``--list`` prints them and an unknown figure is an argument error;
  * ``--only fig7 --time --check --json DIR`` writes the JAX harness's
    payload keys, with 0 violations; a figure with no ``measured_s``
    fails ``--time``; the repository root is refused as ``--json``;
  * Fig 6's rows come in JAX's order, with its model curves and per-verb
    counters (the commit timed once);
  * Fig 8a's and 8b's planner and crossover rows at N = 2**20 equal the
    JAX facade's ``Database.explain`` at the same table sizes, and their
    ``figure`` meets its asserts at N = 2**14 over the profile axis;
  * Fig 10's and fig_scale's ``measured_s`` keys are the JAX benchmark's.
"""
import json
import sys
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import fig6_rsi as jfig6
from benchmarks import fig10_contention as jfig10
from benchmarks import fig_scale as jfig_scale
from benchmarks import run as jrun
from repro.db import Database as JaxDatabase
from repro.fabric import MeshTransport as JaxMeshTransport
from repro_torch.bench import (fig6_rsi, fig8a_joins, fig8b_agg,
                               fig10_contention, fig_scale, queries)
from repro_torch.bench import run as brun
from repro_torch.db import Database
from repro_torch.fabric import netsim

PROFILES = tuple(netsim.PROFILES)


def test_registry_is_the_jax_harness_s():
    assert list(brun.MODULES) == list(jrun.MODULES)
    order = sorted(brun.MODULES, key=brun._figure_key)
    assert order == sorted(jrun.MODULES, key=jrun._figure_key)
    assert order[:3] == ["fig2", "fig6", "fig7"] and order[-1] == "fig_serve"
    for name, mod in brun.MODULES.items():
        jname = jrun.MODULES[name].__name__
        assert mod.__name__ == "repro_torch.bench." + jname.split(".")[-1]


def test_list_and_unknown_figure(capsys):
    assert brun.main(["--list"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in out] == \
        sorted(brun.MODULES, key=brun._figure_key)
    with pytest.raises(SystemExit) as e:
        brun.main(["--only", "fig99", "--device", "cpu"])
    assert e.value.code == 2
    assert "unknown figure 'fig99'" in capsys.readouterr().err


def test_fig7_payload_has_jax_keys_and_no_violation(tmp_path, monkeypatch,
                                                    capsys):
    ours, theirs = tmp_path / "ours", tmp_path / "jax"
    assert brun.main(["--only", "fig7", "--time", "--check", "--json",
                      str(ours), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "fig7/claims,0.00,all_hold" in out
    assert "fig7/planner_join_alternatives/measured," in out
    monkeypatch.setattr(sys, "argv", ["run", "--only", "fig7", "--time",
                                      "--check", "--json", str(theirs)])
    jrun.main()
    got = json.loads((ours / "BENCH_fig7.json").read_text())
    want = json.loads((theirs / "BENCH_fig7.json").read_text())
    assert set(got) == set(want)
    assert got["rows"] == want["rows"]
    assert got["check"]["violations"] == []
    assert got["check"]["targets"] == want["check"]["targets"]
    assert got["check"]["rules_run"] == want["check"]["rules_run"]
    assert set(got["measured_s"]) == set(want["measured_s"])
    assert (got["figure"], got["profile"], got["timed"]) == \
        ("fig7", "default", True)


def test_time_fails_a_figure_without_measured_s(monkeypatch, tmp_path):
    stub = types.SimpleNamespace(
        __name__="stub", __doc__="A stub figure.",
        run=lambda profiles=None, timed=False, device=None:
            ([("stub/row", 1.0, "")], {}))
    monkeypatch.setitem(brun.MODULES, "stub", stub)
    with pytest.raises(SystemExit, match="stub"):
        brun.main(["--only", "stub", "--time", "--device", "cpu"])
    assert brun.main(["--only", "stub", "--device", "cpu", "--json",
                      str(tmp_path)]) == 0
    assert json.loads((tmp_path / "BENCH_stub.json").read_text())["rows"] \
        == [{"name": "stub/row", "us_per_call": 1.0, "derived": ""}]


def test_the_repository_root_is_refused_as_json_dir():
    for path in (brun.REPO_ROOT, brun.REPO_ROOT / "src" / ".."):
        with pytest.raises(ValueError, match="repository root"):
            brun.main(["--only", "fig7", "--json", str(path),
                       "--device", "cpu"])
    assert brun.json_dir(brun.REPO_ROOT / "build") != brun.REPO_ROOT


# ------------------------------------------------------------- fig6 ----

def test_fig6_rows_model_and_counters_equal_jax():
    rows, extras = fig6_rsi.run(timed=True, device="cpu", iters=1)
    jrows, jextras = jfig6.run()
    assert [r[0] for r in rows] == [r[0] for r in jrows]
    assert rows[1:] == jrows[1:]          # all but the measured commit
    assert extras["fabric"] == jextras["fabric"]
    assert extras["modeled_wire_s"] == jextras["modeled_wire_s"]
    for clients in (10, 40, 70):
        assert fig6_rsi.model_curves(clients) == jfig6.model_curves(clients)
    assert set(extras["measured_s"]) == {"fig6/measured_rsi_commit_local"}
    assert "fig6/ipoib_no_help_for_oltp" in {r[0] for r in rows}


# ------------------------------------------------------------ fig8a/b ----

N = 1 << 20


def _jax_db():
    mesh = jax.make_mesh((1,), ("data",))
    return JaxDatabase(transport=JaxMeshTransport(mesh, "data",
                                                  profile=PROFILES[0]))


def _jax_rows(db, q, prefix):
    """The JAX harness's planner rows (``benchmarks/fig8a_joins.py``)."""
    rows, winners = [], {}
    for p in PROFILES:
        ex = db.explain(q, profile=p)
        winners[p] = ex.chosen
        costs = "|".join(f"{a.name}:{a.cost_s * 1e3:.1f}ms"
                         for a in ex.alternatives)
        rows.append((f"{prefix}_planner_{p}", 0.0,
                     f"picked_{ex.chosen}_{costs}"))
    rows.append((f"{prefix}_crossover", 0.0,
                 "|".join(f"{p}:{w}" for p, w in winners.items())))
    return rows


def test_fig8a_planner_rows_equal_jax_explain():
    keys = np.arange(1, N + 1, dtype=np.uint32)
    jdb = _jax_db()
    db = Database(device="cpu", net=PROFILES[0])
    for d, load in ((jdb, jnp.asarray), (db, lambda a: a)):
        for t in ("R", "S"):
            d.create_table(t, N, payload_words=1, partitioning="hash")
            d.table(t).load(load(keys), load(keys))
    for sel in fig8a_joins.SELS:
        rows = []
        fig8a_joins.planner_rows(db, sel, PROFILES, rows)
        jq = jdb.scan("R").join(jdb.scan("S").filter(sel=sel)).aggregate()
        assert rows == _jax_rows(jdb, jq, f"fig8a/sel{sel}")


def test_fig8b_planner_rows_equal_jax_explain():
    keys = np.arange(N, dtype=np.uint32)
    jdb = _jax_db()
    jdb.load_table("T", jnp.asarray(keys), jnp.asarray(keys))
    db = Database(device="cpu", net=PROFILES[0])
    db.load_table("T", keys, keys)
    for G in fig8b_agg.FIGURE_GROUPS:
        rows = []
        fig8b_agg.planner_rows(db, G, PROFILES, rows)
        assert rows == _jax_rows(jdb, jdb.scan("T").aggregate(groups=G),
                                 f"fig8b/groups{G}")


@pytest.mark.parametrize("mod", [fig8a_joins, fig8b_agg],
                         ids=["fig8a", "fig8b"])
def test_figure_meets_its_asserts_small(mod):
    rows, extras = mod.figure(PROFILES, timed=True, device="cpu", n=1 << 14)
    names = [r[0] for r in rows]
    measured = [n for n in names
                if "planner" not in n and "crossover" not in n
                and "modeled_wire" not in n]
    assert set(extras["measured_s"]) == set(measured)
    assert any(len(set(c.values())) > 1
               for c in extras["crossover"].values())
    assert set(extras["modeled_wire_s"]) == set(PROFILES)
    if mod is fig8a_joins:
        assert names[-len(PROFILES):] == [f"fig8a/modeled_wire_{p}"
                                          for p in PROFILES]
        assert set(extras["overlap"]) == {"on_s", "off_s", "chunks",
                                          "replay"}
    else:
        assert names[-1] == "fig8b/kernel_grouped_agg_1M_2048slots"


# ------------------------------------------------- fig10, fig_scale ----

def test_fig10_measured_keys_equal_jax(monkeypatch):
    monkeypatch.setattr(jfig10.timing, "device_time_s",
                        lambda f, *a, **k: 1.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, jextras = jfig10.run(timed=True)
    rows, extras = fig10_contention.run(timed=True, device="cpu")
    assert set(extras["measured_s"]) == set(jextras["measured_s"])
    assert all(s > 0 for s in extras["measured_s"].values())


def test_fig_scale_measured_keys_equal_jax(monkeypatch):
    """At W in (4, 32), two skews: JAX's figure runs on the port's
    economics (``tests/test_torch_scale.py`` holds them equal to JAX's),
    so its panels and timed keys come from its own code in seconds."""
    workers, skews = (4, 32), {"uniform": 0.0, "zipf12": 1.2}
    rows, extras = fig_scale.run(timed=True, workers=workers, skews=skews,
                                 device="cpu")
    monkeypatch.setattr(jfig_scale, "WORKERS", workers)
    monkeypatch.setattr(jfig_scale, "SKEWS", skews)
    monkeypatch.setattr(
        jfig_scale, "_run_economics",
        lambda W, s, shared=True: fig_scale.run_economics(
            W, s, shared=shared, device="cpu"))
    jrows, jextras = jfig_scale.run(timed=True)
    assert set(extras["measured_s"]) == set(jextras["measured_s"])
    assert rows == jrows
