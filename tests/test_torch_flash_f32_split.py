"""The f32 flash kernel's arithmetic, emulated in plain torch on the CPU,
against JAX's ``repro.kernels.ref.flash_attention``.

``flash_f32`` (``src/repro_torch/kernels/csrc/flash_attention.cu``) runs
S = Q.K^T and O += P.V on TF32 tensor-core MMAs with f32 accumulation,
three a product: each operand (Q, K, P after the f32 exp, V) is split into
hi = TF32(x), rounded to nearest with ties away from zero (the rounding of
``cvt.rna.tf32.f32``), and lo = TF32(x - hi), and a.b is taken as hi.lo +
lo.hi + hi.hi.  S is scaled by D^-0.5 after the product.  It walks key
tiles (``F32_TILE_KEYS``: 64 keys up to a padded width of 64, 32 at 128)
with an online softmax in natural units and masks after the product.
:func:`emulate` repeats that arithmetic (TF32 rounding by bit masking,
every product summed in f32, in the CPU's order); the kernel itself runs
on the card only.  On the same numpy inputs it holds JAX's reference
within 2e-5, the tolerance ``chip_smoke.py`` holds the kernel to, over
the f32 cases of its ``FLASH_SWEEP`` and ``CROSS_SWEEP`` that the CPU runs
in a few seconds; a control with one TF32 pass a product of P.V (hi.hi
alone) misses 2e-5, and so does one that takes S by one TF32 pass.

``chip_smoke.sound_plain``'s variants of the plain path (S summed in f64
and rounded once, d reversed, d in halves), whose spread sets the limit
of glm4's f32 gradient check, are held to JAX's reference within 2e-5
too: the yardstick is sound f32 arithmetic, not a looser function.
"""
import functools
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import F32_TILE_KEYS

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-5           # chip_smoke.py: check_flash, check_cross (f32)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _smoke()


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


def emulate(q, k, v, *, causal=True, passes=3, s_passes=3):
    """flash_f32's arithmetic on (B, S, H, D) q and (B, T, KH, D) k, v
    (f32 tensors); head h reads kv head h // (H // KH).  ``passes``: TF32
    products a product of P.V; ``s_passes``: of S."""
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
    tile = F32_TILE_KEYS[32 if D <= 32 else 64 if D <= 64 else 128]
    for k0 in range(0, T, tile):
        kpos = torch.arange(k0, min(k0 + tile, T))[None, :]
        kt = kh[:, :, k0:k0 + tile].transpose(-1, -2)
        s = product(qh, kt, s_passes) * scale
        if causal:
            s = s.masked_fill(kpos > qpos, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        use = torch.where(m_new == -math.inf, 0.0, m_new)
        corr = torch.exp(m - use)
        p = torch.exp(s - use[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + product(p, vh[:, :, k0:k0 + tile],
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
    """The kernel's arithmetic (S and P.V as 3xTF32) within 2e-5."""
    arrs, want = _case(B, S, T, H, KH, D, causal)
    got = emulate(*arrs, causal=causal)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


# each sound variant on the deepest width, a long causal case and a
# non-causal ragged one
SOUND = [CASES[7], CASES[9], CASES[11]]


@pytest.mark.parametrize("variant", sorted(smoke.SOUND_S))
@pytest.mark.parametrize("B,S,T,H,KH,D,causal", SOUND,
                         ids=[IDS[CASES.index(c)] for c in SOUND])
def test_sound_plain_variants_hold_the_f32_tolerance(B, S, T, H, KH, D,
                                                     causal, variant):
    """The plain path with S rounded another sound way (what the gradient
    check's spread measures) is attention to within 2e-5, with and
    without autograd (the check differentiates it)."""
    arrs, want = _case(B, S, T, H, KH, D, causal)
    with smoke.sound_plain("flash_attention", variant):
        got = ops.flash_attention(*arrs, causal=causal, impl="plain")
        q = arrs[0].clone().requires_grad_(True)
        diff = ops.flash_attention(q, *arrs[1:], causal=causal,
                                   impl="plain")
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    torch.testing.assert_close(diff.detach(), want, atol=TOL, rtol=TOL)
    diff.sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())


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
