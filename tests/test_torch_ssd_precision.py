"""The bf16 SSD kernel's rounding, emulated in plain torch on the CPU,
against the plain SSD (``repro_torch.kernels.ref.ssd_scan``) and JAX's
``repro.models.ssm.ssd_chunked``.

``ssd_chunk_bf16`` (``src/repro_torch/kernels/csrc/ssd_scan.cu``) walks
chunks of L = 64 steps (at the mamba2 head, hd 64 and N 128) and runs
every product on bf16 tensor-core MMAs with f32 accumulation.  C B^T is
exact (B and C are bf16).  Each of the three f32 operands (the masked
decay matrix M, the state read for C state^T and X o w of the state
update) is split into a bf16 high part and a bf16 remainder that both go
through the MMA.  :func:`emulate` repeats that arithmetic: each MMA
operand rounded as the kernel rounds it, each product summed in f32.  It
is held to the tolerances ``chip_smoke.py`` holds the kernel to (y within
2e-2, the f32 final state within 2e-3), and a control that rounds X o w
to plain bf16 once, as a kernel without the split would, misses the
state's 2e-3 on the same inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels import ref, ssd_scan as sk

L = 64
Y_TOL, STATE_TOL = 2e-2, 2e-3      # chip_smoke.py: check_ssd, time_ssd


def _bf(t):
    return t.to(torch.bfloat16).float()


def _split(t):
    """t as a bf16 high part and a bf16 remainder."""
    hi = _bf(t)
    return hi, _bf(t - hi)


def emulate(xh, bv, cv, dt, a, state0=None, *, split_w=True):
    """ssd_chunk_bf16's arithmetic on f32 tensors holding bf16 x, B, C
    (xh (B, S, H, hd), bv/cv (B, S, N)), f32 dt (B, S, H) and a (H,).
    Returns (y rounded to bf16, final f32 state).  ``split_w=False``
    rounds X o w to bf16 once (the control)."""
    Bsz, S, H, P = xh.shape
    N = bv.shape[-1]
    st = (torch.zeros((Bsz, H, P, N)) if state0 is None
          else state0.clone())
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool))[None, :, :,
                                                              None]
    ys = []
    for t0 in range(0, S, L):
        n = min(L, S - t0)

        def chunk(t):                           # zero rows past S
            t = t[:, t0:t0 + n]
            return torch.cat([t, t.new_zeros((Bsz, L - n) + t.shape[2:])],
                             1)
        x, b, c, d = chunk(xh), chunk(bv), chunk(cv), chunk(dt)
        seg = torch.cumsum(d * a, 1)                               # B L H
        cb = torch.einsum("bin,bjn->bij", c, b)                    # exact
        decay = torch.exp(seg[:, :, None] - seg[:, None]) * d[:, None]
        m_hi, m_lo = _split(torch.where(causal, cb[..., None] * decay, 0.))
        s_hi, s_lo = _split(st)
        y = (torch.einsum("bln,bhpn->blhp", c, s_hi)
             + torch.einsum("bln,bhpn->blhp", c, s_lo)) * torch.exp(seg)[
                 ..., None]
        y = y + (torch.einsum("bijh,bjhp->bihp", m_hi, x)
                 + torch.einsum("bijh,bjhp->bihp", m_lo, x))
        w = torch.exp(seg[:, -1:] - seg) * d
        xw = x * w[..., None]
        w_hi, w_lo = (_split(xw) if split_w
                      else (_bf(xw), torch.zeros_like(xw)))
        st = (st * torch.exp(seg[:, -1])[:, :, None, None]
              + torch.einsum("blhp,bln->bhpn", w_hi, b)
              + torch.einsum("blhp,bln->bhpn", w_lo, b))
        ys.append(y[:, :n])
    return _bf(torch.cat(ys, 1)), st


def _inputs(seed, S, *, state0):
    """B = H = 2 at the mamba2 head widths (hd 64, N 128), drawn as
    chip_smoke.py draws them: x, B, C normal at 0.5 in bf16, dt =
    softplus(normal), a = -exp(0.3 normal), state0 normal."""
    rng = np.random.default_rng(seed)
    B, H, P, N = 2, 2, 64, 128

    def bf(shape):
        return _bf(torch.from_numpy(
            (rng.standard_normal(shape) * 0.5).astype(np.float32)))
    xh, bv, cv = bf((B, S, H, P)), bf((B, S, N)), bf((B, S, N))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, S, H)).astype(np.float32)))
    a = -torch.exp(torch.from_numpy(
        (rng.standard_normal(H) * 0.3).astype(np.float32)))
    s0 = (torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(
        np.float32)) if state0 else None)
    return xh, bv, cv, dt, a, s0


@pytest.mark.parametrize("S", [1024, 1000], ids=["S1024", "ragged"])
@pytest.mark.parametrize("state0", [False, True], ids=["zeros", "state0"])
def test_emulated_kernel_within_chip_tolerances(S, state0):
    xh, bv, cv, dt, a, s0 = _inputs(S + state0, S, state0=state0)
    y, st = emulate(xh, bv, cv, dt, a, s0)
    yr, sr = ref.ssd_scan(xh.to(torch.bfloat16), bv.to(torch.bfloat16),
                          cv.to(torch.bfloat16), dt, a, s0)
    torch.testing.assert_close(y, yr.float(), atol=Y_TOL, rtol=Y_TOL)
    torch.testing.assert_close(st, sr, atol=STATE_TOL, rtol=STATE_TOL)
    if S % 256 == 0:                # JAX's ssd_chunked takes whole chunks
        jy, js = jssm.ssd_chunked(
            *(jnp.asarray(t.numpy()) for t in (xh, bv, cv, dt, a)), 256,
            None if s0 is None else jnp.asarray(s0.numpy()))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=Y_TOL,
                                   rtol=Y_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(js),
                                   atol=STATE_TOL, rtol=STATE_TOL)


def test_one_bf16_rounding_of_the_update_misses_the_state_tolerance():
    """The control: without the split, X o w rounded to bf16 once over 16
    chunks puts the state outside 2e-3 (y is not the problem)."""
    xh, bv, cv, dt, a, s0 = _inputs(1024, 1024, state0=False)
    _, st = emulate(xh, bv, cv, dt, a, s0, split_w=False)
    _, sr = ref.ssd_scan(xh.to(torch.bfloat16), bv.to(torch.bfloat16),
                         cv.to(torch.bfloat16), dt, a, s0)
    assert not torch.allclose(st, sr, atol=STATE_TOL, rtol=STATE_TOL)


def test_zero_padding_of_hd_and_n_leaves_y_and_state_alone():
    """The wrapper pads hd to a multiple of 8 and N to a power of two
    (``ssd_scan._pad``) before the bf16 body runs: zero columns of x, B
    and C add nothing to y or to the state."""
    rng = np.random.default_rng(7)
    B, S, H, P, N = 1, 100, 3, 20, 40

    def t(*shape, scale=0.5):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))
    xh, bv, cv, s0 = t(B, S, H, P), t(B, S, N), t(B, S, N), t(B, H, P, N)
    dt = torch.nn.functional.softplus(t(B, S, H, scale=1.0))
    a = -torch.exp(t(H, scale=0.3))
    y, st = ref.ssd_scan(xh, bv, cv, dt, a, s0)
    yp, stp = ref.ssd_scan(sk._pad(xh, {3: 24}), sk._pad(bv, {2: 64}),
                           sk._pad(cv, {2: 64}), dt, a,
                           sk._pad(s0, {2: 24, 3: 64}))
    assert yp.shape == (B, S, H, 24) and stp.shape == (B, H, 24, 64)
    torch.testing.assert_close(yp[..., :P], y, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(stp[:, :, :P, :N], st, atol=1e-5, rtol=1e-5)
    assert not yp[..., P:].any() and not stp[:, :, P:].any()
    assert not stp[..., N:].any()
