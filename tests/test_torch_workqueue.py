"""The port's work queue (``repro_torch.core.workqueue``) against the JAX
package's: ``claim_ticket_ranges`` (the §3.2 head counter, one FETCH_ADD
per worker) gives the same starts, head and FETCH_ADD counters bit for
bit, and the host ``WorkQueue`` steals from a straggler."""
import time

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import workqueue as jwq
from repro.fabric import LocalTransport as JLocal
from repro_torch._bits import np_to_i32, np_u32
from repro_torch.core import workqueue
from repro_torch.fabric import LocalTransport


def _claim(head0, amounts, prio=None, *, counted=False):
    """(starts, head, stats) of the port and of JAX on the same claim."""
    jt = JLocal() if counted else None
    tt = LocalTransport(device="cpu") if counted else None
    js, jh = jwq.claim_ticket_ranges(
        jnp.asarray(np.asarray(head0, np.uint32)),
        jnp.asarray(np.asarray(amounts, np.uint32)),
        priority=None if prio is None else jnp.asarray(prio, jnp.int32),
        transport=jt)
    ts, th = workqueue.claim_ticket_ranges(
        torch.from_numpy(np_to_i32(head0)),
        torch.from_numpy(np_to_i32(amounts)),
        priority=None if prio is None else torch.tensor(prio,
                                                        dtype=torch.int32),
        transport=tt)
    np.testing.assert_array_equal(np_u32(ts), np.asarray(js))
    np.testing.assert_array_equal(np_u32(th), np.asarray(jh))
    if counted:
        assert tt.stats() == jt.stats()
    return np_u32(ts), np_u32(th)


def test_claim_ranges_partition_the_ticket_space():
    """Under full contention the claimed ranges tile [head0, head0 +
    sum(amounts)) with no gap and no overlap, as JAX's do."""
    rng = np.random.RandomState(0)
    amounts = rng.randint(1, 17, size=(32,)).astype(np.uint32)
    starts, head = _claim([100], amounts, counted=True)
    ivals = sorted(zip(starts, starts + amounts))
    assert ivals[0][0] == 100
    for (a0, a1), (b0, _) in zip(ivals, ivals[1:]):
        assert a1 == b0
    assert ivals[-1][1] == 100 + amounts.sum() == int(head[0])


def test_claim_ranges_priority_orders_the_queue():
    amounts = np.array([4, 2, 8, 1], np.uint32)
    prio = np.array([3, 0, 2, 1], np.int32)    # service order: 1, 3, 2, 0
    starts, head = _claim([0], amounts, prio, counted=True)
    np.testing.assert_array_equal(starts, [11, 0, 3, 2])
    assert int(head[0]) == amounts.sum()


def test_claim_ranges_default_priority_is_worker_order():
    starts, _ = _claim([0], [5, 3, 2])
    np.testing.assert_array_equal(starts, [0, 5, 8])


def test_claim_ranges_zero_amount_worker_holds_place():
    starts, head = _claim([7], [3, 0, 4])
    np.testing.assert_array_equal(starts, [7, 10, 10])
    assert int(head[0]) == 14


def test_claim_ranges_repeated_waves_continue_from_head():
    """The head is updated in place and is the next wave's queue state;
    the counters of three waves equal JAX's, and the u32 head wraps."""
    jt, tt = JLocal(), LocalTransport(device="cpu")
    jh = jnp.asarray(np.array([2 ** 32 - 5], np.uint32))
    th = torch.from_numpy(np_to_i32([2 ** 32 - 5]))
    seen = []
    for _ in range(3):
        js, jh = jwq.claim_ticket_ranges(jh, jnp.array([2, 2], jnp.uint32),
                                         transport=jt)
        ts, th2 = workqueue.claim_ticket_ranges(
            th, torch.tensor([2, 2], dtype=torch.int32), transport=tt)
        assert th2 is th                            # in place
        np.testing.assert_array_equal(np_u32(ts), np.asarray(js))
        seen.extend(int(s) for s in np_u32(ts))
    np.testing.assert_array_equal(np_u32(th), np.asarray(jh))
    assert seen == [(2 ** 32 - 5 + 2 * i) % 2 ** 32 for i in range(6)]
    assert tt.stats() == jt.stats()


def test_workqueue_steals_from_straggler():
    """tests/test_substrate.py's straggler case on the port's queue."""
    wq = workqueue.WorkQueue(4)
    for i in range(64):
        wq.push(0, i)                            # all work on one worker
    done = workqueue.run_workers(wq, lambda x: time.sleep(0.001))
    assert sorted(x for d in done for x in d) == list(range(64))
    assert sum(s.steals for s in wq.stats) > 0
    assert wq.pending() == 0


def test_run_workers_slow_worker_does_less():
    wq = workqueue.WorkQueue(2)
    for i in range(40):
        wq.push(i % 2, i)
    done = workqueue.run_workers(wq, lambda x: time.sleep(0.001),
                                 slow_worker=0, slow_factor=20.0)
    assert sum(len(d) for d in done) == 40
    assert len(done[0]) < len(done[1])
