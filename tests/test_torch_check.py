"""fabric-check in the port: the op-stream lint and the one-sided race
detector, held against the JAX package's ``repro.fabric.check``.

  * **race detector**: every seeded fixture (unfenced WRITE/WRITE overlap,
    lost update next to a FETCH_ADD, install without a lock wave, a stale
    pull, a READ racing a WRITE, an unwaited async route or WRITE, an
    install racing the next prepare, an unfenced retry re-read, an
    unsignaled lock release) runs on both packages' transports and
    reports the same violations: rule, region and detail;
  * **real schedules**: the session waves, the PS trainer loop, the
    windowed and overlapped routes, the pipelined and grouped commits and
    the paged serving engine record clean, access for access and fence
    for fence as JAX records them (both eager);
  * **lint**: the hot paths lint clean on ``MeshTransport(4)`` with JAX's
    budgets (one exchange a route direction, 3 a commit wave), the paged
    decode's page-in and swap-out with none, the
    FETCH_ADD's sort is reported as a declared exemption, and seeded
    faults are each flagged: a sort, an extra exchange, a ``.item()``, a
    bool-mask index or another op sized by the data, and a float wire;
  * **CLI**: exit codes and the final line.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.db import Database as JaxDatabase
from repro.fabric import LocalTransport as JaxLocal
from repro.fabric import check as jcheck
from repro_torch._bits import put_rows
from repro_torch.db import Database
from repro_torch.fabric import LocalTransport, MeshTransport, check, verbs

LOCK = 1 << 31


class _Port:
    check = check

    @staticmethod
    def tp(rec):
        return LocalTransport(recorder=rec, device="cpu")

    @staticmethod
    def u32(vals):
        return torch.tensor(np.asarray(vals, np.uint32).view(np.int32))

    @staticmethod
    def i32(vals):
        return torch.tensor(np.asarray(vals, np.int32))

    @staticmethod
    def db(t):
        return Database(t)


class _Jax:
    check = jcheck

    @staticmethod
    def tp(rec):
        return JaxLocal(recorder=rec)

    @staticmethod
    def u32(vals):
        return jnp.asarray(np.asarray(vals, np.uint32))

    @staticmethod
    def i32(vals):
        return jnp.asarray(np.asarray(vals, np.int32))

    @staticmethod
    def db(t):
        return JaxDatabase(t, jit=False)


def _violations(rep):
    return [(v.rule, v.where, v.detail) for v in rep.violations]


# ------------------------------ pass 2: seeded-violation fixtures --------

def fx_unfenced_write_write(P, rec, t):
    arr = P.u32(np.zeros(16))
    t.write(arr, P.i32([2, 3, 4]), P.u32(np.ones(3)), region="buf")
    t.write(arr, P.i32([4, 5]), P.u32(np.ones(2)), region="buf")


def fx_fenced_writes(P, rec, t):
    arr = P.u32(np.zeros(16))
    t.write(arr, P.i32([2, 3, 4]), P.u32(np.ones(3)), region="buf")
    rec.fence("flush")
    t.write(arr, P.i32([4, 5]), P.u32(np.ones(2)), region="buf")


def fx_lost_update_next_to_fetch_add(P, rec, t):
    words = P.u32(np.zeros(8))
    with rec.agent("w0"):
        v = t.read(words, P.i32([1]), region="ctr")
        t.write(words, P.i32([1]), v + 1, region="ctr")
    with rec.agent("w1"):
        t.fetch_add(words, P.i32([1]), P.u32([1]), region="ctr")


def fx_install_without_lock_wave(P, rec, t):
    rec.declare_locks("T/words", ("T/payload",), lock_bit=LOCK)
    words = P.u32(np.zeros(8))
    pay = P.u32(np.zeros((8, 2)))
    rec.begin_wave()
    t.cas(words, P.i32([1, 2]), P.u32([0, 0]), P.u32([LOCK | 5] * 2),
          region="T/words")
    t.write(pay, P.i32([2, 3]), P.u32(np.ones((2, 2))), region="T/payload")


def fx_stale_pull(P, rec, t):
    rec.note_pull(region="ps/params", worker="w0", observed_epoch=1,
                  current_epoch=5, staleness=2)
    rec.note_pull(region="ps/params", worker="w1", observed_epoch=4,
                  current_epoch=5, staleness=2)


def fx_read_write_race(P, rec, t):
    arr = P.u32(np.zeros(8))
    with rec.agent("reader"):
        t.read(arr, P.i32([3]), region="r")
    with rec.agent("writer"):
        t.write(arr, P.i32([3]), P.u32([1]), region="r")


def fx_read_completion_fences(P, rec, t):
    arr = P.u32(np.zeros(8))
    v = t.read(arr, P.i32([3]), region="r")
    t.write(arr, P.i32([3]), v + 1, region="r")


def _route_async(P, rec, t, wait):
    words = P.u32(np.arange(16))
    buf = P.u32(np.zeros(16))
    with rec.agent("producer"):
        t.write_async(buf, P.i32(np.arange(8)), words[:8],
                      region="async/buf").wait()
    c = t.route_async({"k": words[:8]}, P.i32(np.zeros(8)), cap=16)
    if wait:
        c.wait()
    with rec.agent("consumer"):
        t.read(buf, P.i32(np.arange(8)), region="async/buf")


def fx_unwaited_route_async(P, rec, t):
    _route_async(P, rec, t, wait=False)


def fx_waited_route_async(P, rec, t):
    _route_async(P, rec, t, wait=True)


def _write_async_pair(P, rec, t, fenced):
    buf = P.u32(np.zeros(16))
    with rec.agent("a"):
        t.write_async(buf, P.i32([1, 2]), P.u32([1, 1]), region="route/buf")
    if fenced:
        rec.fence("flush")
    with rec.agent("b"):
        t.write_async(buf, P.i32([2, 3]), P.u32([1, 1]), region="route/buf")


def fx_unwaited_write_async_pair(P, rec, t):
    _write_async_pair(P, rec, t, fenced=False)


def fx_fenced_write_async_pair(P, rec, t):
    _write_async_pair(P, rec, t, fenced=True)


def _install_vs_prepare(P, rec, t, fenced, first=(2, 3), second=(3, 4),
                        agents=("wave0", "wave1"), kind="route-roundtrip"):
    words = P.u32(np.zeros(16))
    with rec.agent(agents[0]):
        t.write_async(words, P.i32(first), P.u32([9] * len(first)),
                      region="acct/words")
    if fenced:
        rec.fence(kind)
    with rec.agent(agents[1]):
        t.read(words, P.i32(second), region="acct/words")


def fx_install_overlapping_next_prepare(P, rec, t):
    _install_vs_prepare(P, rec, t, fenced=False)


def fx_install_fenced_before_next_prepare(P, rec, t):
    _install_vs_prepare(P, rec, t, fenced=True)


def fx_unfenced_retry_reread(P, rec, t):
    _install_vs_prepare(P, rec, t, fenced=False, first=(0,), second=(0,),
                        agents=("winner", "retry"))


def fx_fenced_retry_reread(P, rec, t):
    _install_vs_prepare(P, rec, t, fenced=True, first=(0,), second=(0,),
                        agents=("winner", "retry"), kind="commit-complete")


def fx_own_cas_inside_rmw_window(P, rec, t):
    words = P.u32(np.zeros(8))
    v = t.read(words, P.i32([0]), region="acct/words")
    t.cas(words, P.i32([0]), v, P.u32([LOCK]), region="acct/words")
    t.write(words, P.i32([0]), P.u32([5]), region="acct/words")


def fx_foreign_atomic_in_rmw_window(P, rec, t):
    words = P.u32(np.zeros(8))
    with rec.agent("rmw"):
        t.read(words, P.i32([0]), region="acct/words")
    rec.fence("round")
    with rec.agent("bumper"):
        t.fetch_add(words, P.i32([0]), P.u32([1]), region="acct/words")
    rec.fence("round")
    with rec.agent("rmw"):
        t.write(words, P.i32([0]), P.u32([5]), region="acct/words")


def _lock_table(P, rec, t, signaled, reclaim=True):
    db = P.db(t)
    slots = db.create_table("slots", 4, payload_words=1, num_timestamps=16)
    claimed = slots.claim_locks(3 if not reclaim else 1, tag=3)
    for row in claimed:
        slots.release_lock(row, signaled=signaled)
    if reclaim:
        assert slots.claim_locks(1, tag=4) == claimed


def fx_lock_table_claims(P, rec, t):
    _lock_table(P, rec, t, signaled=False, reclaim=False)


def fx_unsignaled_release_reclaim(P, rec, t):
    _lock_table(P, rec, t, signaled=False)


def fx_signaled_release_reclaim(P, rec, t):
    _lock_table(P, rec, t, signaled=True)


FIXTURES = {
    "unfenced_write_write": ["ww-race"],
    "fenced_writes": [],
    "lost_update_next_to_fetch_add": ["lost-update", "lost-update"],
    "install_without_lock_wave": ["lock-protocol"],
    "stale_pull": ["staleness"],
    "read_write_race": ["rw-race"],
    "read_completion_fences": [],
    "unwaited_route_async": ["rw-race"],
    "waited_route_async": [],
    "unwaited_write_async_pair": ["ww-race"],
    "fenced_write_async_pair": [],
    "install_overlapping_next_prepare": ["rw-race"],
    "install_fenced_before_next_prepare": [],
    "unfenced_retry_reread": ["rw-race"],
    "fenced_retry_reread": [],
    "own_cas_inside_rmw_window": [],
    "foreign_atomic_in_rmw_window": ["lost-update"],
    "lock_table_claims": [],
    "unsignaled_release_reclaim": ["lost-update"],
    "signaled_release_reclaim": [],
}


def _run_fixture(P, name):
    rec = P.check.ScheduleRecorder()
    globals()[f"fx_{name}"](P, rec, P.tp(rec))
    return P.check.check_schedule(rec, target=name)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_reports_equal_jax(name):
    ours, theirs = _run_fixture(_Port, name), _run_fixture(_Jax, name)
    assert _violations(ours) == _violations(theirs)
    rules = sorted(v.rule for v in ours.violations)
    want = FIXTURES[name]
    if name == "lost_update_next_to_fetch_add":
        assert set(rules) == {"lost-update"}     # pairwise + RMW window
    else:
        assert rules == sorted(want)


@pytest.mark.parametrize("seed", range(8))
def test_random_schedules_report_as_jax(seed):
    """Random access streams (verbs, regions, agents, waves, fences, lock
    and epoch declarations) fed to both recorders as numpy indices: the
    same violations, in the same order."""
    rng = np.random.default_rng(seed)
    recs = [check.ScheduleRecorder(), jcheck.ScheduleRecorder()]
    for rec in recs:
        rec.declare_locks("L", ("P",), lock_bit=LOCK)
        rec.declare_epoch("E", params_region="P", staleness=1)
    for _ in range(60):
        op = rng.integers(0, 10)
        verb = ["READ", "WRITE", "CAS", "FETCH_ADD"][rng.integers(0, 4)]
        region = ["L", "P", "E", "X"][rng.integers(0, 4)]
        agent = f"a{rng.integers(0, 3)}"
        idx = rng.integers(-1, 12, rng.integers(1, 5))
        ok = rng.integers(0, 2, idx.size).astype(bool)
        new = np.where(rng.integers(0, 2, idx.size) == 1, LOCK | 3, 3)
        deferred = bool(rng.integers(0, 4) == 0)
        current = int(rng.integers(1, 4))
        for rec in recs:
            if op == 0:
                rec.fence("round")
            elif op == 1:
                rec.begin_wave()
            elif op == 2:
                rec.note_pull(region="P", worker=agent, observed_epoch=1,
                              current_epoch=current, staleness=1)
            else:
                with rec.agent(agent):
                    a = rec.record(verb, region, idx, region_len=12, ok=ok,
                                   new=new.astype(np.uint32),
                                   deferred=deferred)
                    if deferred and op == 3:
                        rec.complete(a)
    ours = check.check_schedule(recs[0])
    theirs = jcheck.check_schedule(recs[1])
    assert _violations(ours) == _violations(theirs)


def test_fixture_details_name_the_verb_pair_and_region():
    v = _run_fixture(_Port, "unfenced_write_write").violations[0]
    assert v.where == "buf" and "WRITE#0" in v.detail \
        and "WRITE#1" in v.detail and "rows {4}" in v.detail
    v = _run_fixture(_Port, "install_without_lock_wave").violations[0]
    assert v.where == "T/payload" and "rows {3}" in v.detail \
        and "T/words" in v.detail and "wave 1" in v.detail
    v = _run_fixture(_Port, "stale_pull").violations[0]
    assert "'w0'" in v.detail and "lag 4" in v.detail and "k=2" in v.detail
    blob = " ".join(v.detail for v in _run_fixture(
        _Port, "lost_update_next_to_fetch_add").violations)
    assert "FETCH_ADD#2" in blob and "WRITE#1" in blob


# ------------------------- negatives: real protocols record clean --------

def _schedule(rec):
    acc = [(a.seq, a.verb, a.region, a.lo, a.hi,
            None if a.rows is None else np.asarray(a.rows).tolist(),
            a.agent, a.wave, a.gfence, a.afence,
            sorted(np.asarray(a.meta.get("acquired", [])).tolist()))
           for a in rec.accesses]
    fen = [(f.seq, f.kind, f.scope) for f in rec.fences]
    notes = [{k: v for k, v in n.items()} for n in rec.notes]
    return acc, fen, notes, rec.summary()


RECORDED = {
    "sessions_rsi": lambda c, **k: c.record_session_waves("rsi", **k),
    "sessions_2pc": lambda c, **k: c.record_session_waves("2pc", **k),
    "paramserver": lambda c, **k: c.record_paramserver(
        staleness=2, steps=3, workers=2, **k),
    "windowed_route": lambda c, **k: c.record_windowed_route(**k),
    "overlapped_route": lambda c, **k: c.record_overlapped_route(**k),
    "pipelined_commit": lambda c, **k: c.record_pipelined_commit(2, **k),
    "grouped_commit": lambda c, **k: c.record_grouped_commit(1, **k),
    "paged_decode": lambda c, **k: c.record_paged_decode(
        hot_frac=0.25, prefetch=True, **k),
    "paged_decode_all_hot": lambda c, **k: c.record_paged_decode(
        hot_frac=1.0, prefetch=False, **k),
}


@pytest.mark.parametrize("name", sorted(RECORDED))
def test_real_schedules_record_clean_as_jax(name):
    ours = RECORDED[name](check, device="cpu")
    theirs = RECORDED[name](jcheck)
    assert ours.accesses, "schedule must not be trivially empty"
    assert _schedule(ours) == _schedule(theirs)
    rep = check.check_schedule(ours, target=name)
    assert rep.ok, rep.render()


def test_session_and_grouped_schedules_cover_the_protocol():
    rec = check.record_session_waves("rsi", device="cpu")
    assert {a.region for a in rec.accesses} >= {
        "acct/words", "acct/payload", "acct/cids", "oracle/clock"}
    rec = check.record_grouped_commit(1, device="cpu")
    assert any(a.verb == "READ" and a.region == "acct/words"
               for a in rec.accesses), "retry refresh READ must appear"
    assert sum(a.verb == "CAS" and a.region == "acct/words"
               for a in rec.accesses) >= 2
    rec = check.record_paramserver(device="cpu")
    assert any(n["kind"] == "ps_pull" for n in rec.notes)
    assert any(a.verb == "FETCH_ADD" and a.region == "ps/epoch"
               for a in rec.accesses)


# ------------------------------------------------------- pass 1: lint ----

def test_hot_paths_lint_clean_with_jax_budgets():
    reps = [check.lint_route(1, device="cpu"),
            check.lint_route(3, chunks=4, device="cpu"),
            check.lint_route(2, response=True, device="cpu"),
            check.lint_route(3, chunks=4, overlap=True, device="cpu"),
            check.lint_route(2, window=4, device="cpu"),
            check.lint_commit("rsi", "cpu"), check.lint_commit("2pc", "cpu"),
            check.lint_commit_pipelined(2, "cpu"),
            check.lint_commit_grouped(3, "cpu"),
            check.lint_ps_push("cpu")]
    for rep in reps:
        assert rep.ok and not rep.exempted, rep.render()
    assert check.commit_all_to_all_budget(2) == \
        jcheck.commit_all_to_all_budget(2) == 6


def test_chunked_route_counts_one_exchange_per_direction():
    tp = check._mesh_transport("cpu")

    def body(k):
        tp.route({"k": k}, k % tp.n, cap=8, chunks=4, overlap=True)
        tp.route({"k": k}, k % tp.n, cap=8, chunks=4)
        return k.sum()

    with check.OpStream(tp) as s:
        tp.run(body, (torch.ones(16, dtype=torch.int32),), True)
    assert [c.kind for c in s.collectives] == ["all_to_all"] * 2
    assert [len(c.dtypes) for c in s.collectives] == [4, 1]
    # the transport's methods are its class's again after the block
    assert "exchange" not in vars(tp) and "_make_exchange" not in vars(tp)


def test_fetch_add_sort_is_a_declared_exemption():
    cas_rep, fa_rep = check.lint_verbs("cpu")
    assert cas_rep.ok and not cas_rep.exempted
    assert fa_rep.ok and fa_rep.exempted
    for v, why in fa_rep.exempted:
        assert v.rule == "sort-free" and "fabric/verbs.py" in v.where \
            and "(fetch_add)" in v.where
        assert "ROADMAP" in why
    assert "exempt [sort-free]" in fa_rep.render()
    # the rule itself stays: without the exemption the same call fails
    words = torch.zeros(8, dtype=torch.int32)
    rep = check.lint_fn(lambda w: verbs.fetch_add(
        w, torch.zeros(3, dtype=torch.int32),
        torch.ones(3, dtype=torch.int32)), words, rules=[check.SortFree()])
    assert not rep.ok and len(rep.violations) == len(fa_rep.exempted)


def test_seeded_sort_is_flagged_with_its_site():
    rep = check.lint_fn(lambda x: torch.argsort(x), torch.arange(8.0),
                        rules=[check.SortFree()], target="argsort")
    assert [v.rule for v in rep.violations] == ["sort-free"]
    assert "aten::sort" in rep.violations[0].detail


def test_seeded_extra_exchange_is_flagged():
    tp = MeshTransport(4, device="cpu")

    def body(v):
        return tp.exchange(tp.exchange(v))

    rep = check.lint_fn(lambda v: tp.run(body, (v,), False),
                        torch.zeros(16, dtype=torch.int32), transport=tp,
                        rules=[check.CollectiveBudget({"all_to_all": 1})])
    assert [v.detail for v in rep.violations] == [
        "2 all_to_all site(s) issued, budget is 1"]
    ok = check.lint_fn(lambda v: tp.run(tp.exchange, (v,), False),
                       torch.zeros(16, dtype=torch.int32), transport=tp,
                       rules=[check.CollectiveBudget({"all_to_all": 1})])
    assert ok.ok, ok.render()


def test_seeded_item_is_flagged():
    rep = check.lint_fn(lambda x: x[int(x.sum()) % 4], torch.ones(8),
                        rules=[check.NoHostTransfer()], target="item")
    assert [v.rule for v in rep.violations] == ["no-host-transfer"]
    assert "_local_scalar_dense" in rep.violations[0].detail
    rep = check.lint_fn(lambda x: x.sum().item(), torch.ones(8),
                        rules=[check.NoHostTransfer()])
    assert not rep.ok


def _bool_put(x):
    x[x > 1] = 0
    return x


@pytest.mark.parametrize("fault,op", [
    (lambda x: x[x > 1], "aten::index"),
    (_bool_put, "aten::index_put_"),
    (lambda x: torch.nonzero(x), "aten::nonzero"),
    (lambda x: torch.masked_select(x, x > 1), "aten::masked_select"),
])
def test_seeded_data_sized_op_is_flagged(fault, op):
    """An op whose output size the host must read from the device (a
    bool-mask index runs ``nonzero`` below the dispatcher) is a host
    sync; an integer index is not."""
    rep = check.lint_fn(fault, torch.arange(8.0),
                        rules=[check.NoHostTransfer()], target=op)
    assert [v.rule for v in rep.violations] == ["no-host-transfer"]
    assert op in rep.violations[0].detail
    ok = check.lint_fn(lambda x: x[torch.tensor([1, 3])], torch.arange(8.0),
                       rules=[check.NoHostTransfer()])
    assert ok.ok, ok.render()


@pytest.mark.parametrize("seed", range(6))
def test_put_rows_is_the_bool_mask_put_without_a_sync(seed):
    """``put_rows`` writes what ``dst[idx[keep]] = values[keep]`` writes,
    row 0 and dropped requests included, and lints host-free; so does the
    WRITE verb, at every index out of range too."""
    rng = np.random.default_rng(seed)
    R = int(rng.integers(1, 9))
    dst = torch.from_numpy(rng.integers(0, 99, (R, 3)).astype(np.int32))
    idx = torch.from_numpy(rng.permutation(np.arange(-2, R + 2))[:R + 1])
    keep = (idx >= 0) & (idx < R)
    vals = torch.from_numpy(
        rng.integers(100, 199, (idx.numel(), 3)).astype(np.int32))
    want = dst.clone()
    want[idx[keep]] = vals[keep]
    rep = check.lint_fn(put_rows, dst, idx, vals, keep,
                        rules=[check.NoHostTransfer()])
    assert rep.ok, rep.render()
    assert torch.equal(dst, want)
    words = torch.zeros(R, dtype=torch.int32)
    rep = check.lint_fn(verbs.write, words, idx, vals[:, 0],
                        rules=[check.NoHostTransfer()])
    assert rep.ok, rep.render()
    assert torch.equal(words, torch.zeros(R, dtype=torch.int32).index_put_(
        (idx[keep],), vals[keep, 0]))


def test_seeded_float_wire_is_flagged():
    tp = MeshTransport(4, device="cpu")
    rep = check.lint_fn(lambda v: tp.run(tp.exchange, (v,), False),
                        torch.zeros(16), transport=tp,
                        rules=[check.PackedWire()], target="raw-f32")
    assert not rep.ok and "float32" in rep.violations[0].detail
    rep = check.lint_fn(lambda v: tp.run(tp.exchange, (v,), False),
                        torch.zeros(16, dtype=torch.int32), transport=tp,
                        rules=[check.PackedWire()], target="i32")
    assert rep.ok, rep.render()


def test_budget_regressions_both_directions():
    from repro_torch.core import rsi
    dev = torch.device("cpu")
    tp = check._mesh_transport(dev)
    wv = [check._txns(4, 4 * i, dev) for i in range(2)]
    bad = check.lint_fn(
        lambda s, w: rsi.commit_pipelined(s, w, transport=tp),
        check._store(32, dev), wv, transport=tp,
        rules=[check.CollectiveBudget(
            {"all_to_all": check.COMMIT_ALL_TO_ALL_BUDGET})])
    assert [v.detail for v in bad.violations] == [
        "6 all_to_all site(s) issued, budget is 3"]
    gs = [check._txns(4, 4 * g, dev) for g in range(3)]
    bad = check.lint_fn(
        lambda s, g: rsi.commit_grouped(s, g, transport=tp),
        check._store(64, dev), gs, transport=tp,
        rules=[check.CollectiveBudget({"all_to_all": 2})])
    assert [v.detail for v in bad.violations] == [
        "3 all_to_all site(s) issued, budget is 2"]


# --------------------------------------------------- CLI + summaries -----

def test_suites_mirror_jax_but_serve():
    """Every suite and figure of the JAX package, the serve suite and
    fig_serve included (the name is older than the serve suite's port)."""
    assert set(check.SUITES) == set(jcheck.SUITES)
    assert check.FIGURE_SUITES == jcheck.FIGURE_SUITES
    assert check.FIGURE_SUITES["fig_serve"] == ("serve", "sim")
    assert check.SCHEDULE_RULES == jcheck.SCHEDULE_RULES


def test_paged_decode_lints_clean():
    """Page-in and swap-out: sort-free, host-free, collective-free, with
    JAX's targets."""
    reps = check.lint_paged_decode(2, device="cpu")
    assert [r.target for r in reps] == ["serve/page_in[2b]",
                                        "serve/swap_out[2b]"]
    for rep in reps:
        assert rep.ok, rep.render()
        assert not rep.exempted


def test_serve_suite_targets_equal_jax():
    reps = check.run_suite("serve", "cpu")
    assert [r.target for r in reps] == [r.target for r in
                                        jcheck.run_suite("serve")]
    assert all(r.ok for r in reps), [r.render() for r in reps]


def test_cli_all_figures_pass_with_the_final_line(tmp_path, capsys):
    out = tmp_path / "check.json"
    rc = check.main(["--figure", "all", "-q", "--device", "cpu", "--json",
                     str(out)])
    text = capsys.readouterr().out
    assert rc == 0
    assert text.strip().splitlines()[-1] == \
        "fabriccheck: 27 targets, 9 rules, 0 violation(s)"
    assert "exempt [sort-free]" in text          # -q still prints it
    payload = json.loads(out.read_text())
    assert payload["ok"] and payload["violations"] == []
    assert {e["target"] for e in payload["exemptions"]} == \
        {"verbs/fetch_add"}


def test_cli_exit_codes_reflect_violations(monkeypatch, capsys):
    bad = check.Report("seeded", ("sort-free",),
                       [check.Violation("sort-free", "<top>", "seeded")])
    monkeypatch.setitem(check.SUITES, "verbs", lambda d: [bad])
    assert check.main(["--suite", "verbs", "-q", "--device", "cpu"]) == 1
    assert "1 violation(s)" in capsys.readouterr().out
