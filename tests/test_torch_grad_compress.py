"""The port's int8 gradient compression with error feedback
(``repro_torch.train.grad_compress``) against the JAX package's: codes,
scales and residuals bit for bit on the same inputs, ``wire_bytes``
equal, and the properties of ``tests/test_grad_compress.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import grad_compress as jgc
from repro_torch.train import grad_compress as gc

SHAPES = ((3, 130), (77,), (4, 256))


def _g(seed, shape, scale=10.0):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(shape) * scale).astype(np.float32)
    # exact ties of round-half-to-even and an all-zero block
    g.reshape(-1)[:4] = [0.5, 1.5, -2.5, 0.0]
    return g


@pytest.mark.parametrize("block", [32, 256])
@pytest.mark.parametrize("seed", range(4))
def test_compress_with_feedback_bit_equal(seed, block):
    for shape in SHAPES:
        g = _g(seed, shape)
        r = _g(seed + 100, shape, 0.01)
        jc, js, jr = jgc.compress_with_feedback(jnp.asarray(g),
                                                jnp.asarray(r), block=block)
        tc, ts, tr = gc.compress_with_feedback(torch.from_numpy(g),
                                               torch.from_numpy(r),
                                               block=block)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        back = gc.decompress(tc, ts, shape, block=block)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jgc.decompress(jc, js, shape,
                                                    block=block)))


def test_codes_on_ties_and_zero_blocks():
    """A block whose max is 127 codes its values as themselves, rounding
    halves to even; a zero block codes zeros with scale 0."""
    b = np.zeros((2, 4), np.float32)
    b[0] = [127.0, 0.5, 1.5, -2.5]
    codes, scale = gc.compress(torch.from_numpy(b), block=4)
    np.testing.assert_array_equal(codes.numpy(),
                                  [[127, 0, 2, -2], [0, 0, 0, 0]])
    np.testing.assert_array_equal(scale.numpy(), [1.0, 0.0])


@pytest.mark.parametrize("block", [32, 256])
def test_roundtrip_error_bounded(block):
    g = torch.from_numpy(_g(7, (3, 130)))
    codes, scale = gc.compress(g, block=block)
    back = gc.decompress(codes, scale, g.shape, block=block)
    assert float((back - g).abs().max()) <= float(g.abs().max()) / 127


def test_error_feedback_sums_to_truth():
    shape = (77,)
    r = torch.zeros(shape)
    total_true = torch.zeros(shape)
    total_sent = torch.zeros(shape)
    rng = np.random.default_rng(0)
    for _ in range(20):
        g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        total_true += g
        codes, scale, r = gc.compress_with_feedback(g, r, block=64)
        total_sent += gc.decompress(codes, scale, shape, block=64)
    np.testing.assert_allclose((total_sent + r).numpy(), total_true.numpy(),
                               atol=1e-4)


def test_compressed_grads_tree_and_wire_size():
    params = {"w": np.ones((64, 64), np.float32),
              "b": np.ones((7,), np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    grads = {k: v * 0.1 for k, v in tp.items()}
    deq, res = gc.compressed_grads(grads, gc.init_residuals(tp))
    jdeq, jres = jgc.compressed_grads({k: v * 0.1 for k, v in jp.items()},
                                      jgc.init_residuals(jp))
    assert set(deq) == set(grads)
    for k in params:
        np.testing.assert_array_equal(deq[k].numpy(), np.asarray(jdeq[k]))
        np.testing.assert_array_equal(res[k].numpy(), np.asarray(jres[k]))
    for block in (32, 256):
        assert gc.wire_bytes(tp, block=block) == jgc.wire_bytes(
            jp, block=block)
    comp, unc = gc.wire_bytes(tp)
    assert comp < 0.3 * unc


def test_training_with_compression_still_descends():
    w = torch.tensor([3.0, -2.0, 1.5])
    res = torch.zeros_like(w)
    l0 = float((w ** 2).sum())
    for _ in range(50):
        g = 2 * w
        codes, scale, res = gc.compress_with_feedback(g, res, block=4)
        w = w - 0.1 * gc.decompress(codes, scale, w.shape, block=4)
    assert float((w ** 2).sum()) < 0.01 * l0
