"""The benchmark's shape, on the CPU:

  * ``BENCHMARK.json`` names files that exist, every metric has a reader,
    each per-layer metric moves an end-to-end metric every cell of its
    reports, and names and limits keep to the benchmark's contract; so do
    the cells withdrawn to ``later.json``, entered;
  * a cell added as data alone (a traffic file and an entry) runs, with
    no other file edited;
  * the frozen roofline arithmetic gives the kernel table's bounds at the
    cells' shapes (PERF.md: 0.382 ms for the rank at A = 128M, 1.38 ms for
    the scatter of (128M, 2) into (256M, 3), 0.386 ms for the u32 keys
    entry at 2^26);
  * a run with no card prints no result and exits 2.
"""
import json
import re
import subprocess
import sys

import pytest

from nambench import roofline
from nambench.harness import main, run_cell
from nambench.spec import PACKAGE, ROOT, SECTIONS, Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keeps_to_its_contract():
    raw = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(raw) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert raw["paths"] == ["nambench"]
    assert 1 <= raw["run_seconds"] <= 51
    spec = Spec()
    for c in raw["configs"]:
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    used = {w["config"] for w in raw["workloads"]}
    assert used == {c["name"] for c in raw["configs"]}
    names = [m["name"] for m in raw["end_to_end"] + raw["per_layer"]]
    assert len(names) == len(set(names)) and all(map(NAME.match, names))
    assert "setup_s" in names
    for m in raw["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in raw["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        spec.config(w["config"])
        kind = spec.traffic(w["traffic"])["kind"]
        assert (PACKAGE / "kinds" / f"{kind}.py").is_file()
        e2e = {m.name for m in spec.end_to_end_of(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.per_layer_of(w["name"])
    for m in spec.end_to_end + spec.per_layer:
        assert callable(spec.reader(m.name))
    for m in spec.per_layer:
        for cell in m.workloads:
            assert m.moves in {e.name for e in spec.end_to_end_of(cell)}
        if m.name.endswith("_roofline_pct.query"):
            assert spec.kernel_names(m.name)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_later_cells_are_withdrawn_whole():
    """``later.json`` holds cells the benchmark does not run, with the
    configuration and the metrics that only they use; entered, they keep
    to the rules ``BENCHMARK.json`` keeps."""
    raw = json.loads((ROOT / "BENCHMARK.json").read_text())
    later = json.loads((PACKAGE / "later.json").read_text())
    assert set(later) <= set(SECTIONS)
    for key in SECTIONS:
        assert not ({e["name"] for e in later.get(key, ())}
                    & {e["name"] for e in raw[key]})
    spec = Spec(later=True)
    for w in later["workloads"]:
        with pytest.raises(KeyError):
            Spec().cell(w["name"])
        spec.config(w["config"])
        e2e = {m.name for m in spec.end_to_end_of(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.per_layer_of(w["name"])
    for m in spec.end_to_end + spec.per_layer:
        assert callable(spec.reader(m.name))
    for m in spec.per_layer:
        for cell in m.workloads:
            assert m.moves in {e.name for e in spec.end_to_end_of(cell)}


def test_a_cell_added_as_data_runs(small):
    """A new mix of an existing kind: one traffic file and one entry."""
    raw = json.loads((small.root / "BENCHMARK.json").read_text())
    mix = json.loads((small.package / "traffic" / "oltp-checkout.json"
                      ).read_text())
    mix.update(zipf_s=0.5, sessions_per_wave=32)
    (small.package / "traffic" / "oltp-checkout-z05.json").write_text(
        json.dumps(mix))
    raw["workloads"].append({"name": "oltp-checkout-z05",
                             "config": "nam-oltp-tpcw",
                             "traffic": "oltp-checkout-z05", "chips": 1,
                             "why": "a milder skew"})
    for m in raw["end_to_end"] + raw["per_layer"]:
        if "oltp-checkout" in m.get("workloads", ()):
            m["workloads"].append("oltp-checkout-z05")
    (small.root / "BENCHMARK.json").write_text(json.dumps(raw))
    spec = Spec(small.root, small.package)
    res = run_cell(spec, "oltp-checkout-z05", 11, 0.2, False, device="cpu")
    assert res["correct"] and set(res["metrics"]) == {"txn_per_s",
                                                      "setup_s"}
    assert res["attempted"] > 0


@pytest.mark.parametrize("what,ms", [
    ("rank", "0.382"), ("scatter", "1.38"), ("agg", "0.386")])
def test_roofline_pins_kernel_table_bounds(what, ms):
    """The bounds as the kernel table prints them, to its digits."""
    A = 128_000_000
    nbytes = {"rank": roofline.rank_bytes(A, 1),
              "scatter": roofline.scatter_bytes(A, 2, 2 * A),
              "agg": roofline.agg_bytes(A, 1 << 26)}[what]
    digits = len(ms.split(".")[1])
    assert f"{roofline.seconds(nbytes) * 1e3:.{digits}f}" == ms


def test_roofline_agg_table_by_plan():
    assert roofline.agg_table_slots("dist_agg", 1 << 20) == 1 << 20
    assert roofline.agg_table_slots("rdma_agg", 1 << 20) == 1 << 22
    with pytest.raises(ValueError):
        roofline.agg_table_slots("no_such_plan", 64)


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert main(["--workload", "olap-join-mix", "--seed", "1",
                 "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "refused" in out.err


def test_unknown_cell_fails_before_any_work():
    with pytest.raises(KeyError):
        Spec().cell("no-such-cell")


def test_command_runs_from_the_checkout_root():
    """``python3 nambench/run.py --help`` finds its package and the port
    from the root, with nothing on PYTHONPATH."""
    out = subprocess.run([sys.executable, "nambench/run.py", "--help"],
                         cwd=ROOT, capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0 and "--workload" in out.stdout


def test_blocks_deal_every_kind_once_a_block():
    """Seeds differ in order, never in the mix: each block of a closed
    loop's requests holds every kind once."""
    from nambench import draw
    seed = 2 ** 33 + 1
    deal = draw.Blocks(4, seed)
    got = [deal.next() for _ in range(4 * 50)]
    assert draw.Blocks(4, seed).next() == got[0]
    for b in range(50):
        assert sorted(got[4 * b:4 * b + 4]) == [0, 1, 2, 3]
    other = draw.Blocks(4, seed + 1)
    assert [other.next() for _ in range(200)] != got


@pytest.mark.parametrize("zipf_s", [0.0, 0.99])
def test_distinct_rows_are_distinct_and_seeded(zipf_s):
    import numpy as np

    from nambench import draw
    cdf = draw.zipf_cdf(50, zipf_s)
    rows = draw.distinct_rows(2000, 3, 50, cdf, np.random.default_rng(7))
    assert rows.shape == (2000, 3) and rows.min() >= 0 and rows.max() < 50
    assert (np.sort(rows, 1)[:, 1:] != np.sort(rows, 1)[:, :-1]).all()
    again = draw.distinct_rows(2000, 3, 50, cdf, np.random.default_rng(7))
    assert (rows == again).all()
    if zipf_s:          # id 0 the hottest
        assert np.bincount(rows.ravel(), minlength=50).argmax() == 0
