"""The SSD kernel's rounding in both input types, emulated in plain torch
on the CPU, against the plain SSD (``repro_torch.kernels.ref.ssd_scan``)
and JAX's ``repro.models.ssm.ssd_chunked``.

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

``ssd_chunk_f32`` runs the same body on f32 x, B and C, in chunks of 16
steps at the mamba2 head: each of x, B and C is split into a bf16 high part
and a bf16 remainder as well, and every product of two inputs takes three
MMAs (hi.hi + hi.lo + lo.hi).  ``emulate(..., f32=True)`` repeats that,
with y left in f32; it holds y and the state within 2e-3 (the kernel's f32
tolerance in ``chip_smoke.py``), and a control that rounds B and C to plain
bf16 once misses it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels import ref, ssd_scan as sk

L = 64
L_F32 = 16                         # ssd_chunk_f32's chunk at the mamba2 head
Y_TOL, STATE_TOL = 2e-2, 2e-3      # chip_smoke.py: check_ssd, time_ssd
F32_TOL = 2e-3                     # f32 y and state: check_ssd


def _bf(t):
    return t.to(torch.bfloat16).float()


def _split(t):
    """t as a bf16 high part and a bf16 remainder."""
    hi = _bf(t)
    return hi, _bf(t - hi)


def _pair(t, split=True):
    """t as (high part, remainder) MMA operands: split, or rounded to
    bf16 once with no remainder."""
    return _split(t) if split else (_bf(t), torch.zeros_like(t))


def emulate(xh, bv, cv, dt, a, state0=None, *, split_w=True, f32=False,
            split_bc=True, chunk=None):
    """The chunked body's arithmetic on xh (B, S, H, hd), bv/cv (B, S, N),
    f32 dt (B, S, H) and a (H,), in chunks of ``chunk`` steps (L, or L_F32
    with ``f32``).  bf16 (``ssd_chunk_bf16``): x, B and C hold bf16 values
    and enter the MMAs as they are.  ``f32`` (``ssd_chunk_f32``): x, B and
    C are f32 and split, every product of two inputs three MMAs, y left in
    f32.  Returns (y, final f32 state).  The controls: ``split_w=False``
    rounds X o w to bf16 once; ``split_bc=False`` rounds B and C to bf16
    once (f32 only)."""
    Bsz, S, H, P = xh.shape
    N = bv.shape[-1]
    L = chunk or (L_F32 if f32 else globals()["L"])
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
        if f32:                 # (high part, remainder) of each input
            xs, bs, cs = _split(x), _pair(b, split_bc), _pair(c, split_bc)
        else:                   # exact bf16 operands, no remainder
            xs, bs, cs = ((t, torch.zeros_like(t)) for t in (x, b, c))

        def mm(eq, u, v):       # hi.hi + hi.lo + lo.hi, f32 sums
            return (torch.einsum(eq, u[0], v[0]) + torch.einsum(eq, u[0], v[1])
                    + torch.einsum(eq, u[1], v[0]))
        seg = torch.cumsum(d * a, 1)                               # B L H
        cb = mm("bin,bjn->bij", cs, bs)
        decay = torch.exp(seg[:, :, None] - seg[:, None]) * d[:, None]
        ms = _split(torch.where(causal, cb[..., None] * decay, 0.))
        y = mm("bln,bhpn->blhp", cs, _split(st)) * torch.exp(seg)[..., None]
        y = y + mm("bijh,bjhp->bihp", ms, xs)
        w = torch.exp(seg[:, -1:] - seg) * d
        ws = _pair(x * w[..., None], split_w)
        st = (st * torch.exp(seg[:, -1])[:, :, None, None]
              + mm("blhp,bln->bhpn", ws, bs))
        ys.append(y[:, :n])
    y = torch.cat(ys, 1)
    return (y if f32 else _bf(y)), st


def _inputs(seed, S, *, state0, f32=False):
    """B = H = 2 at the mamba2 head widths (hd 64, N 128), drawn as
    chip_smoke.py draws them: x, B, C normal at 0.5 in bf16 (f32 with
    ``f32``), dt = softplus(normal), a = -exp(0.3 normal), state0
    normal."""
    rng = np.random.default_rng(seed)
    B, H, P, N = 2, 2, 64, 128

    def bf(shape):
        t = torch.from_numpy(
            (rng.standard_normal(shape) * 0.5).astype(np.float32))
        return t if f32 else _bf(t)
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


@pytest.mark.parametrize("S", [1024, 1000], ids=["S1024", "ragged"])
@pytest.mark.parametrize("state0", [False, True], ids=["zeros", "state0"])
def test_emulated_f32_kernel_within_f32_tolerance(S, state0):
    """ssd_chunk_f32: x, B and C split too, three MMAs a product; y and the
    state within 2e-3 of the plain SSD and of JAX's ssd_chunked."""
    xh, bv, cv, dt, a, s0 = _inputs(S + state0 + 7, S, state0=state0,
                                    f32=True)
    y, st = emulate(xh, bv, cv, dt, a, s0, f32=True)
    yr, sr = ref.ssd_scan(xh, bv, cv, dt, a, s0)
    torch.testing.assert_close(y, yr, atol=F32_TOL, rtol=F32_TOL)
    torch.testing.assert_close(st, sr, atol=F32_TOL, rtol=F32_TOL)
    if S % 256 == 0:
        jy, js = jssm.ssd_chunked(
            *(jnp.asarray(t.numpy()) for t in (xh, bv, cv, dt, a)), 256,
            None if s0 is None else jnp.asarray(s0.numpy()))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=F32_TOL,
                                   rtol=F32_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(js),
                                   atol=F32_TOL, rtol=F32_TOL)


def test_one_bf16_rounding_of_f32_b_and_c_misses_the_f32_tolerance():
    """The control: with f32 inputs, B and C rounded to bf16 once (no
    remainder) put y or the state outside 2e-3."""
    xh, bv, cv, dt, a, s0 = _inputs(1031, 1024, state0=False, f32=True)
    y, st = emulate(xh, bv, cv, dt, a, s0, f32=True, split_bc=False)
    yr, sr = ref.ssd_scan(xh, bv, cv, dt, a, s0)
    assert not (torch.allclose(y, yr, atol=F32_TOL, rtol=F32_TOL)
                and torch.allclose(st, sr, atol=F32_TOL, rtol=F32_TOL))
