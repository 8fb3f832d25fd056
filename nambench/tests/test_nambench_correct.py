"""``correct`` on the CPU, at small sizes:

  * every cell's run through the port's plain path agrees with the plain
    reference on every number compared (the references agree with the
    port);
  * the control (the reference in float32 in the program's place, or the
    commit with validation switched off) and every fault a cell can have
    make ``correct`` false;
  * the plain references agree with brute force on small inputs.
"""
import numpy as np
import pytest
import torch

from nambench import faults
from nambench.harness import run_cell
from nambench.reference import olap, oltp

CELLS = ("olap-join-mix", "oltp-checkout", "olap-agg-large-g",
         "oltp-checkout-zipf")
SEED = 2 ** 31 + 977        # more than 32 signed bits hold


def _plants():
    out = []
    for cell in CELLS:
        fam = "olap" if cell.startswith("olap") else "oltp"
        out += [(cell, name) for name in ("control", *faults.FAULTS[fam])]
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_port_agrees_with_reference(small, cell):
    res = run_cell(small, cell, SEED, 0.3, False, device="cpu")
    assert res["attempted"] > 0
    assert all(value == 0 for _, value, _ in res["checks"]), res["checks"]
    assert res["correct"]
    names = {m.name for m in small.end_to_end_of(cell)}
    assert set(res["metrics"]) == names and "setup_s" in names
    assert all(m["value"] > 0 for m in res["metrics"].values())


@pytest.mark.parametrize("cell,plant", _plants())
def test_plant_makes_correct_false(small, cell, plant):
    kind = small.traffic(small.cell(cell).traffic)["kind"]
    res = run_cell(small, cell, SEED + 1, 0.2, False, device="cpu",
                   planted=faults.plant(kind, plant))
    assert not res["correct"], res["checks"]


def test_join_sum_brute_force():
    g = torch.Generator().manual_seed(5)
    rk = torch.randperm(300, generator=g).to(torch.int32) - 7   # u32 wrap
    rv = torch.randint(-2 ** 31, 2 ** 31 - 1, (300,), generator=g,
                       dtype=torch.int32)
    sk = torch.randint(-10, 400, (500,), generator=g, dtype=torch.int32)
    sv = torch.randint(-2 ** 31, 2 ** 31 - 1, (500,), generator=g,
                       dtype=torch.int32)
    r = {int(k) & 0xFFFFFFFF: int(v) & 0xFFFFFFFF
         for k, v in zip(rk, rv)}
    want = sum(r[int(k) & 0xFFFFFFFF] * (int(v) & 0xFFFFFFFF)
               for k, v in zip(sk, sv) if int(k) & 0xFFFFFFFF in r)
    assert olap.join_sum(rk, rv, sk, sv) == want & 0xFFFFFFFF


def test_group_sums_brute_force():
    g = torch.Generator().manual_seed(6)
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (2000,), generator=g,
                         dtype=torch.int32)
    vals = torch.randint(-2 ** 31, 2 ** 31 - 1, (2000,), generator=g,
                         dtype=torch.int32)
    want = [0] * 37
    for k, v in zip(keys.tolist(), vals.tolist()):
        want[(k & 0xFFFFFFFF) % 37] += v & 0xFFFFFFFF
    got = olap.group_sums(keys, vals, 37)
    assert got.tolist() == [w & 0xFFFFFFFF for w in want]


def test_snapshot_store_arbitration_and_retry():
    """Two sessions update one product and two insert into one row: the
    first in wave order takes each.  The losers run again in the next
    wave (the second into a row of its own), reading again, so each
    validates against the version it lost to; every committed update
    takes one off its product's stock."""
    ref = oltp.SnapshotStore(records=8, base_rows=4)
    reads = np.array([[True, False], [True, False], [True, False]])
    ok, cid = ref.commit_wave(np.array([[1, 5], [1, 6], [2, 5]]),
                              np.arange(6).reshape(3, 2), reads)
    assert ok.tolist() == [True, False, False]
    assert cid.tolist() == [2, 3, 4]
    ok, cid = ref.commit_wave(np.array([[1, 6], [2, 7]]),
                              np.arange(6, 10).reshape(2, 2), reads[:2])
    assert ok.tolist() == [True, True]
    assert cid.tolist() == [5, 6]
    assert ref.cids[[1, 2, 5, 6, 7]].tolist() == [5, 6, 2, 5, 6]
    assert ref.src[[1, 2, 5, 6, 7]].tolist() == [6, 8, 1, 7, 9]
    assert ref.stock.tolist() == [0, 2 ** 32 - 2, 2 ** 32 - 1, 0]
    assert ref.stats == {"commits": 3, "aborts": 2}
    assert ref.bitvec(8).tolist() == [False, False] + [True] * 5 + [False]


def test_a_stale_update_is_caught(small):
    """An update computed from a read older than the version it replaces
    (a session whose stock word ignores the last winner) is a lost
    update: the store's stock and the readback disagree with the
    reference."""
    from unittest import mock

    from nambench.kinds import oltp_checkout
    sessions = oltp_checkout.sessions

    def stale(db, prods, ins, pay, reads):
        out = sessions(db, prods, ins, pay, reads)
        for s in out:
            s._payload[0][:, 0] = 0xFFFFFFFF    # as if every read saw the load
        return out

    with mock.patch.object(oltp_checkout, "sessions", stale):
        res = run_cell(small, "oltp-checkout-zipf", SEED + 2, 0.2, False,
                       device="cpu")
    checks = {name: value for name, value, _ in res["checks"]}
    assert checks["outcome_mismatches"] == 0
    assert checks["store_mismatches"] > 0 and checks["readback_failures"] > 0
    assert not res["correct"]
