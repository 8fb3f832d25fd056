"""The port's attention against the JAX package, on the CPU.

* ``ref.flash_attention`` (the plain version the CPU runs for the flash
  kernel) against JAX's Pallas ``ops.flash_attention`` in interpret mode
  and its ``ref.flash_attention``, over the JAX sweep
  (tests/test_kernels.py:47-52) and ragged shapes the Pallas kernel does
  not take.  Tolerances: 2e-5 in f32, 2e-2 in bf16, those of
  tests/test_kernels.py:62 (f32 sums in another order; one bf16 rounding
  of the output, and the Pallas kernel's bf16 p).
* the port's ``grouped_attend`` (prefill through the flash dispatch, decode
  with ``kv_len`` through the chunked path) against JAX's, in f32 within
  2e-5 and in bf16 within 2e-2.
Inputs come from numpy with a seed and go to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as fa, ops, ref
from repro_torch.models import attention as attn

TOL = {np.float32: 2e-5, "bf16": 2e-2}


def _arrays(seed, shapes, bf16):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if bf16:       # round once so both packages get the same bf16 values
        out = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
               for a in out]
    return out


def _both(arrs, bf16):
    j = [jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32) for a in arrs]
    t = [torch.from_numpy(a).to(torch.bfloat16 if bf16 else torch.float32)
         for a in arrs]
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# (s, t, h, kh, d, causal, bf16): the JAX sweep, all multiples of 64
JAX_SWEEP = [(128, 128, 4, 4, 32, True, False),
             (256, 256, 4, 2, 32, True, False),
             (128, 256, 8, 1, 64, False, False),
             (128, 128, 4, 4, 32, True, True)]
RAGGED = [(100, 100, 8, 2, 24, True, False),
          (77, 133, 4, 4, 40, False, False),
          (65, 65, 16, 1, 8, True, True),
          (33, 90, 8, 8, 128, False, True)]


@pytest.mark.parametrize("s,t,h,kh,d,causal,bf16", JAX_SWEEP)
def test_plain_flash_matches_pallas_and_jax_ref(s, t, h, kh, d, causal,
                                                bf16):
    arrs = _arrays(s + t + h, [(2, s, h, d), (2, t, kh, d), (2, t, kh, d)],
                   bf16)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, bf16)
    got = ref.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = TOL["bf16" if bf16 else np.float32]
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                  block_k=64)
    jr = jref.flash_attention(jq, jk, jv, causal=causal)
    for want in (pallas, jr):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("s,t,h,kh,d,causal,bf16", RAGGED)
def test_plain_flash_ragged_matches_jax_ref(s, t, h, kh, d, causal, bf16):
    arrs = _arrays(s * t, [(1, s, h, d), (1, t, kh, d), (1, t, kh, d)], bf16)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, bf16)
    tol = TOL["bf16" if bf16 else np.float32]
    np.testing.assert_allclose(
        _f32(ref.flash_attention(tq, tk, tv, causal=causal)),
        _f32(jref.flash_attention(jq, jk, jv, causal=causal)),
        atol=tol, rtol=tol)


def test_plain_flash_blocks_long_prompts():
    """More query rows than one block of the plain version: the blocks
    together equal one softmax over all of them."""
    arrs = _arrays(3, [(1, 1100, 4, 16),
                       (1, 1100, 2, 16), (1, 1100, 2, 16)], False)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, False)
    np.testing.assert_allclose(_f32(ref.flash_attention(tq, tk, tv)),
                               _f32(jref.flash_attention(jq, jk, jv)),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_grouped_attend_prefill_matches_jax(bf16, monkeypatch):
    B, S, K, G, hd = 2, 48, 2, 4, 16
    arrs = _arrays(7, [(B, S, K, G, hd), (B, S, K, hd), (B, S, K, hd)], bf16)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, bf16)
    calls = []
    real = ops.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", spy)
    got = attn.grouped_attend(tq, tk, tv, causal=True)
    want = jattn.grouped_attend(jq, jk, jv, causal=True)
    assert calls == [(B, S, K * G, hd)]       # the prefill took the kernel
    tol = TOL["bf16" if bf16 else np.float32]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("bf16", [False, True])
def test_grouped_attend_decode_matches_jax(bf16, monkeypatch):
    """One query against a T-long cache with kv_len valid entries: the
    chunked path, never the kernel."""
    B, T, K, G, hd = 3, 40, 2, 2, 16
    arrs = _arrays(8, [(B, 1, K, G, hd), (B, T, K, hd), (B, T, K, hd)], bf16)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, bf16)
    monkeypatch.setattr(ops, "flash_attention", None)   # must not be called
    tol = TOL["bf16" if bf16 else np.float32]
    for pos in (0, 17, T - 1):
        got = attn.grouped_attend(
            tq, tk, tv, causal=False, q_pos=torch.tensor([pos]),
            kv_len=torch.tensor(pos + 1), chunk=1)
        want = jattn.grouped_attend(
            jq, jk, jv, causal=False, q_pos=jnp.array([pos]),
            kv_len=jnp.int32(pos + 1), chunk=1)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_grouped_attend_chunked_long_sequence_matches_jax():
    """Explicit positions keep the chunked path; S above the chunk splits
    the queries into chunks in both packages."""
    B, S, K, G, hd = 1, 1024, 1, 2, 8
    arrs = _arrays(9, [(B, S, K, G, hd), (B, S, K, hd), (B, S, K, hd)],
                   False)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, False)
    pos = np.arange(S, dtype=np.int32)
    got = attn.grouped_attend(tq, tk, tv, causal=True,
                              q_pos=torch.from_numpy(pos), chunk=256)
    want = jattn.grouped_attend(jq, jk, jv, causal=True,
                                q_pos=jnp.asarray(pos), chunk=256)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros((1, 8, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError, match="kernel"):
        ops.flash_attention(q, q, q, impl="kernel")
    assert fa.takes_head_dim(8) and fa.takes_head_dim(128)
    assert not fa.takes_head_dim(12) and not fa.takes_head_dim(136)


@pytest.mark.gpu
def test_flash_kernel_matches_plain_on_card():
    """Runs on the card only (``python3 chip_smoke.py`` sweeps far more)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        q = torch.randn((2, 100, 8, 64), generator=g, device=dev).to(dtype)
        k = torch.randn((2, 100, 2, 64), generator=g, device=dev).to(dtype)
        v = torch.randn((2, 100, 2, 64), generator=g, device=dev).to(dtype)
        torch.testing.assert_close(
            ops.flash_attention(q, k, v).float(),
            ops.flash_attention(q, k, v, impl="plain").float(),
            atol=tol, rtol=tol)
