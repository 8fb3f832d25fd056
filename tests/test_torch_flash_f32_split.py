"""The f32 flash kernel's arithmetic, emulated in plain torch on the CPU,
against JAX's ``repro.kernels.ref.flash_attention``.

``flash_f32`` (``src/repro_torch/kernels/csrc/flash_attention.cu``) takes
S = Q.K^T as the plain f32 product (fmas over d in order, on the CUDA
cores), scaled by D^-0.5, and runs O += P.V on TF32 tensor-core MMAs with
f32 accumulation, three a product: P (after the f32 exp) and V are split
into hi = TF32(x), rounded to nearest with ties away from zero (the
rounding of ``cvt.rna.tf32.f32``), and lo = TF32(x - hi), and p.v is taken
as hi.hi + hi.lo + lo.hi.  It walks key tiles of 64 rows with an online
softmax in natural units and masks after the product.  :func:`emulate`
repeats that arithmetic (TF32 rounding by bit masking, every product
summed in f32; S summed in the CPU's order, not the kernel's); the
kernel itself runs on the card only.  On the same
numpy inputs it holds JAX's reference within 2e-5, the tolerance
``chip_smoke.py`` holds the kernel to, over the f32 cases of its
``FLASH_SWEEP`` and ``CROSS_SWEEP`` that the CPU runs in a few seconds; a
control with one TF32 pass a product of P.V (hi.hi alone) misses 2e-5, and
so does one that takes S by one TF32 pass.  (Three TF32 passes would hold
S within 2e-5 too; the kernel takes S as the plain f32 product because
glm4's f32 gradient check needs S bit for bit, see the source.)
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

TILE = 64            # keys a tile of flash_f32
TOL = 2e-5           # chip_smoke.py: check_flash, check_cross (f32)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away from
    zero: cvt.rna.tf32.f32 as bit arithmetic on the f32 pattern."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b on the kernel's MMAs: three TF32 products (hi.lo + lo.hi +
    hi.hi), or hi.hi alone with ``passes=1``; f32 sums."""
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 1:
        return ah @ bh
    return ah @ bl + al @ bh + ah @ bh


def emulate(q, k, v, *, causal=True, passes=3, s_passes=None):
    """flash_f32's arithmetic on (B, S, H, D) q and (B, T, KH, D) k, v
    (f32 tensors); head h reads kv head h // (H // KH).  ``passes``: TF32
    products a product of P.V; ``s_passes``: of S too (None: S as a CPU
    f32 product, whose blocked sums are not the kernel's in-order fmas, so
    S is emulated only to within the tolerance: that the kernel's S equals
    the plain product bit for bit is held on the card, by phase train's
    equal f32 losses in ``chip_smoke.py``)."""
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    qh = q.transpose(1, 2)                                       # B H S D
    kh = k.repeat_interleave(H // KH, 2).transpose(1, 2)         # B H T D
    vh = v.repeat_interleave(H // KH, 2).transpose(1, 2)
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    m = torch.full((B, H, S), -math.inf)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, D))
    qpos = torch.arange(S)[:, None]
    for k0 in range(0, T, TILE):
        kpos = torch.arange(k0, min(k0 + TILE, T))[None, :]
        kt = kh[:, :, k0:k0 + TILE].transpose(-1, -2)
        s = (qh @ kt if s_passes is None
             else product(qh, kt, s_passes)) * scale
        if causal:
            s = s.masked_fill(kpos > qpos, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        use = torch.where(m_new == -math.inf, 0.0, m_new)
        corr = torch.exp(m - use)
        p = torch.exp(s - use[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + product(p, vh[:, :, k0:k0 + TILE],
                                              passes)
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).transpose(1, 2)


@functools.lru_cache(maxsize=None)
def _case(B, S, T, H, KH, D, causal):
    """Normal f32 inputs from numpy, seeded by the shape, and JAX's
    reference output on them."""
    rng = np.random.default_rng(B * 7919 + S * 31 + T * 17 + H + D)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, T, KH, D), (B, T, KH, D))]
    want = jref.flash_attention(*(jnp.asarray(a) for a in arrs),
                                causal=causal)
    return ([torch.from_numpy(a) for a in arrs],
            torch.from_numpy(np.array(want, np.float32)))


# (B, S, T, H, KH, D, causal): chip_smoke.FLASH_SWEEP's cases up to S = 300
# and one long one, then CROSS_SWEEP's f32 cases (non-causal, ragged T on
# either side of S, T = 1, S = 1)
CASES = [
    (2, 128, 128, 4, 4, 32, True),
    (2, 256, 256, 4, 2, 32, True),
    (2, 128, 256, 8, 1, 64, False),
    (2, 100, 100, 8, 2, 24, True),
    (1, 77, 133, 4, 4, 40, False),
    (1, 64, 100, 4, 2, 64, True),
    (1, 65, 65, 2, 2, 8, True),
    (1, 300, 300, 32, 4, 128, True),
    (1, 200, 200, 16, 1, 128, True),
    (1, 2048, 2048, 4, 2, 64, True),
    (2, 300, 129, 8, 2, 64, False),
    (1, 129, 300, 4, 4, 128, False),
    (1, 127, 1, 8, 8, 64, False),
    (2, 1, 300, 4, 2, 128, False),
]
IDS = [f"B{b}-S{s}-T{t}-H{h}-KH{kh}-D{d}-{'causal' if c else 'full'}"
       for b, s, t, h, kh, d, c in CASES]


@pytest.mark.parametrize("B,S,T,H,KH,D,causal", CASES, ids=IDS)
def test_three_tf32_passes_hold_the_f32_tolerance(B, S, T, H, KH, D,
                                                  causal):
    """The kernel's arithmetic (S plain f32, P.V 3xTF32), and 3xTF32 on S
    as well: both within 2e-5."""
    arrs, want = _case(B, S, T, H, KH, D, causal)
    got = emulate(*arrs, causal=causal)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    torch.testing.assert_close(emulate(*arrs, causal=causal, s_passes=3),
                               want, atol=TOL, rtol=TOL)


# the control on the deepest width and on a long causal case
CONTROL = [CASES[7], CASES[9], CASES[11]]


@pytest.mark.parametrize("B,S,T,H,KH,D,causal", CONTROL,
                         ids=[IDS[CASES.index(c)] for c in CONTROL])
def test_one_tf32_pass_misses_the_f32_tolerance(B, S, T, H, KH, D, causal):
    arrs, want = _case(B, S, T, H, KH, D, causal)
    got = emulate(*arrs, causal=causal, passes=1)
    assert not torch.allclose(got, want, atol=TOL, rtol=TOL)
    got = emulate(*arrs, causal=causal, s_passes=1)
    assert not torch.allclose(got, want, atol=TOL, rtol=TOL)


def test_tf32_rounds_to_nearest_ties_away():
    """TF32 keeps 10 mantissa bits: 1 + 2^-11 is a tie (away: 1 + 2^-10),
    a hair below it rounds down, and the remainder of a split is exact."""
    one = torch.tensor([1.0 + 2 ** -11, -(1.0 + 2 ** -11),
                        1.0 + 2 ** -11 - 2 ** -20, 3.0])
    assert tf32(one).tolist() == [1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0,
                                  3.0]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        1000).astype(np.float32))
    hi, lo = split(x)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert ((x - (hi + lo)).abs() <= x.abs() * 2.0 ** -21).all()
