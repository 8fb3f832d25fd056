"""The port's SSD scan and Mamba2 block against the JAX package, on the CPU.

* ``ref.ssd_scan`` (the plain version the CPU runs for the SSD kernel):
  y against JAX's Pallas ``ops.ssd_scan`` in interpret mode and its
  sequential ``ref.ssd_scan``; y and the final state against
  ``repro.models.ssm.ssd_chunked``.  Tolerance 2e-3, that of
  tests/test_kernels.py:84 (the chunked form and the recurrence add the
  same f32 terms in another order).
* ``apply_ssm`` and ``apply_ssm_decode`` against JAX's on the same
  parameters, in f32 (2e-5: the same arithmetic, another order of
  additions in the matrix products) and bf16 (``_causal_conv`` bit for
  bit: its K bf16 products are added in JAX's order).
Inputs come from numpy with a seed and go to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduce_config as jred
from repro.kernels import ops as jops, ref as jref
from repro.models import ssm as jssm
from repro.models.common import Mk as JMk
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import ops, ref, ssd_scan as sk
from repro_torch.models import ssm


def _inputs(seed, B, S, H, hd, N):
    rng = np.random.default_rng(seed)
    xh = (rng.standard_normal((B, S, H, hd)) * 0.5).astype(np.float32)
    bv = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    cv = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    return xh, bv, cv, dt, a


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


# (s, h, hd, n, chunk): the JAX sweep, tests/test_kernels.py:70-74
@pytest.mark.parametrize("s,h,hd,n,chunk", [(64, 8, 16, 16, 32),
                                            (128, 4, 32, 8, 64),
                                            (256, 16, 16, 32, 128)])
def test_plain_ssd_matches_pallas_and_jax_ref(s, h, hd, n, chunk):
    arrs = _inputs(s + h, 2, s, h, hd, n)
    y, state = ref.ssd_scan(*_t(arrs))
    assert y.shape == (2, s, h, hd) and state.shape == (2, h, hd, n)
    pallas = jops.ssd_scan(*_j(arrs), chunk=chunk, head_block=min(h, 4))
    for want in (pallas, jref.ssd_scan(*_j(arrs))):
        np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=2e-3,
                                   rtol=2e-3)


@pytest.mark.parametrize("S,chunk", [(128, 32), (96, 96)])
def test_plain_ssd_matches_ssd_chunked_y_and_state(S, chunk):
    arrs = _inputs(S, 1, S, 4, 16, 16)
    y, state = ref.ssd_scan(*_t(arrs))
    jy, jstate = jssm.ssd_chunked(*_j(arrs), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-3,
                               rtol=2e-3)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), atol=2e-3,
                               rtol=2e-3)


def test_plain_ssd_initial_state_and_ragged_length():
    """Two halves from the carried state equal the whole; a length that is
    no multiple of the block takes the padded tail (dt = 0)."""
    xh, bv, cv, dt, a = _inputs(5, 2, 101, 4, 16, 8)
    s0 = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 4, 16, 8)).astype(np.float32))
    whole = ref.ssd_scan(*_t((xh, bv, cv, dt, a)), s0)
    h = 40
    y1, st1 = ref.ssd_scan(*_t((xh[:, :h], bv[:, :h], cv[:, :h], dt[:, :h],
                                a)), s0)
    y2, st2 = ref.ssd_scan(*_t((xh[:, h:], bv[:, h:], cv[:, h:], dt[:, h:],
                                a)), st1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), whole[0], atol=2e-5,
                               rtol=2e-5)
    torch.testing.assert_close(st2, whole[1], atol=2e-5, rtol=2e-5)
    # against the JAX recurrence from zeros
    y0, _ = ref.ssd_scan(*_t((xh, bv, cv, dt, a)))
    np.testing.assert_allclose(
        y0.numpy(), np.asarray(jref.ssd_scan(*_j((xh, bv, cv, dt, a)))),
        atol=2e-3, rtol=2e-3)


@pytest.fixture(scope="module")
def block():
    """Reduced mamba2 config and one SSM sublayer's parameters, drawn by
    JAX and carried across as numpy."""
    jcfg = jred(jget("mamba2-370m"))
    cfg = reduce_config(get_config("mamba2-370m"))
    jp = jssm.build_ssm(jcfg, JMk("init", jax.random.PRNGKey(3)))
    # A_log, dt_bias and gnorm initialise to zeros, D to ones: move them
    rng = np.random.default_rng(4)
    jp = {k: (v + 0.3 * rng.standard_normal(v.shape).astype(np.float32)
              if k in ("A_log", "dt_bias", "gnorm", "D") else v)
          for k, v in jp.items()}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, cfg, jp, tp


def test_apply_ssm_matches_jax(block):
    jcfg, cfg, jp, tp = block
    x = np.random.default_rng(10).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    got = ssm.apply_ssm(cfg, tp, torch.from_numpy(x))
    want = jssm.apply_ssm(jcfg, jp, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)


def test_apply_ssm_decode_matches_jax(block):
    jcfg, cfg, jp, tp = block
    x = np.random.default_rng(11).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32)
    jst = jssm.init_ssm_state(jcfg, 2)
    tst = ssm.init_ssm_state(cfg, 2)
    for k, (shp, dt) in ssm.ssm_state_shape(cfg, 2).items():
        assert tuple(jst[k].shape) == shp and tst[k].dtype == dt
    for t in range(6):
        jy, jst = jssm.apply_ssm_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]),
                                        jst)
        ty, tst = ssm.apply_ssm_decode(cfg, tp, torch.from_numpy(
            x[:, t:t + 1]), tst)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-5,
                                   rtol=2e-5)
        np.testing.assert_allclose(tst["state"].numpy(),
                                   np.asarray(jst["state"]), atol=2e-5,
                                   rtol=2e-5)
        for k in ("conv_x", "conv_B", "conv_C"):     # bf16 caches, exact
            np.testing.assert_array_equal(
                tst[k].float().numpy(), np.asarray(jst[k], np.float32))


def test_causal_conv_bf16_sum_bit_for_bit(monkeypatch):
    """The K bf16 products are summed in JAX's order and rounding, bit for
    bit (silu set aside in both packages); with silu, within two bf16
    ulps: JAX's bf16 logistic on the CPU rounds each step in bf16 (sigmoid
    of 0.0390625 comes out 0.51171875), torch's rounds once (0.509765625),
    and the product with x rounds again."""
    rng = np.random.default_rng(12)
    x = np.asarray(jnp.asarray(rng.standard_normal((2, 9, 24)), jnp.bfloat16),
                   np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32) * 0.1
    c = np.asarray(jnp.asarray(rng.standard_normal((2, 3, 24)),
                               jnp.bfloat16), np.float32)

    def both():
        out = []
        for cache in (None, c):
            jy, jc = jssm._causal_conv(
                jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                None if cache is None else jnp.asarray(cache, jnp.bfloat16))
            ty, tc = ssm._causal_conv(
                torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                None if cache is None else torch.from_numpy(cache).bfloat16())
            np.testing.assert_array_equal(tc.float().numpy(),
                                          np.asarray(jc, np.float32))
            out.append((ty.float().numpy(), np.asarray(jy, np.float32)))
        return out

    for ty, jy in both():
        np.testing.assert_allclose(ty, jy, atol=0, rtol=2 ** -6)
    monkeypatch.setattr(jax.nn, "silu", lambda v: v)
    monkeypatch.setattr(torch.nn.functional, "silu", lambda v: v)
    for ty, jy in both():
        np.testing.assert_array_equal(ty, jy)


def test_softplus_matches_jax():
    """``jax.nn.softplus`` has no threshold: log(1 + e^x) at every x, to
    two f32 ulps (the two libraries' logaddexp round differently)."""
    x = np.linspace(-30, 40, 701).astype(np.float32)
    np.testing.assert_allclose(
        ssm._softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), atol=0, rtol=2.4e-7)


def test_ssd_wrapper_refuses_what_the_kernel_does_not_take():
    xh, bv, cv, dt, a = _t(_inputs(1, 1, 8, 2, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        sk.ssd_scan(xh, bv, cv, dt, a)
    with pytest.raises(ValueError, match="kernel"):
        ops.ssd_scan(xh, bv, cv, dt, a, impl="kernel")
    assert sk.takes_state_dim(128) and sk.takes_state_dim(16)
    assert sk.takes_state_dim(8) and sk.takes_state_dim(24)
    assert sk.takes_state_dim(512) and sk.takes_state_dim(1024)
    assert not sk.takes_state_dim(1025) and not sk.takes_state_dim(0)


@pytest.mark.gpu
def test_ssd_kernel_matches_plain_on_card():
    """Runs on the card only (``python3 chip_smoke.py`` sweeps far more)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    arrs = [t.cuda() for t in _t(_inputs(2, 2, 300, 4, 32, 64))]
    y, st = ops.ssd_scan(*arrs)
    yp, stp = ops.ssd_scan(*arrs, impl="plain")
    torch.testing.assert_close(y, yp, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(st, stp, atol=2e-3, rtol=2e-3)
