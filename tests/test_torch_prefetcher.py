"""``repro_torch.data.Prefetcher`` against the JAX package's
(``repro.data.pipeline.Prefetcher``):

  * with a prompt consumer both give ``SyntheticLM``'s batches, equal and
    in order;
  * with a consumer that leaves the queue full past the put's timeout,
    the port's stream is every batch of ``it_fn`` in order, none lost,
    where JAX's loop drops the batch it built at each timeout (shown side
    by side: JAX's put waits 1 s, the port's a patched 10 ms);
  * ``close`` stops the thread, also while its put waits on a full queue.
"""
import itertools
import threading
import time

import numpy as np
import pytest

from repro.data.pipeline import Prefetcher as JaxPrefetcher
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro_torch.data import Prefetcher, SyntheticLM, pipeline


def _counter():
    it = itertools.count()
    lock = threading.Lock()

    def next_item():
        with lock:
            return next(it)
    return next_item


def test_prompt_consumer_gets_jax_s_batches():
    kw = dict(vocab_size=97, seq_len=16, global_batch=4, seed=3)
    ours = Prefetcher(SyntheticLM(**kw).next_batch, depth=2)
    theirs = JaxPrefetcher(JaxSyntheticLM(**kw).next_batch, depth=2)
    try:
        for _ in range(6):
            a, b = ours.next(), theirs.next()
            assert sorted(a) == sorted(b) == ["labels", "tokens"]
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    finally:
        assert ours.close()
        theirs.close()


def test_a_full_queue_loses_no_batch(monkeypatch):
    monkeypatch.setattr(pipeline, "PUT_TIMEOUT_S", 0.01)
    ours = Prefetcher(_counter(), depth=1)
    theirs = JaxPrefetcher(_counter(), depth=1)
    try:
        time.sleep(2.5)          # both queues stay full past the timeout
        got = [ours.next(timeout=5) for _ in range(8)]
        jgot = [theirs.next(timeout=5) for _ in range(3)]
    finally:
        assert ours.close()
        theirs.close()
    assert got == list(range(8))
    assert jgot[0] == 0 and jgot[1] > 1      # JAX dropped batch 1 at least


@pytest.mark.parametrize("full", [False, True])
def test_close_stops_the_thread(monkeypatch, full):
    monkeypatch.setattr(pipeline, "PUT_TIMEOUT_S", 0.05)
    p = Prefetcher(_counter(), depth=1)
    if full:
        time.sleep(0.2)
    else:
        assert p.next(timeout=5) == 0
    assert p.close()
    assert not p._t.is_alive()
