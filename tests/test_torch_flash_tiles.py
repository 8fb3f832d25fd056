"""The bf16 flash kernel's arithmetic, emulated in plain torch on the CPU,
against JAX's ``repro.kernels.ref.flash_attention``.

``flash_bf16`` (``src/repro_torch/kernels/csrc/flash_attention.cu``) walks
key tiles of 128 rows for query tiles of 128 rows (192 in the 64-wide
body, three consumer warpgroups of 64 rows; causal, a query tile reads the
key tiles up to its last row), keeps the running max in
log2 units and takes ``exp2`` with ``D^-0.5 log2(e)`` folded in, rounds p
to bf16 against the running max before P.V, rescales O by ``corr`` on
every tile, and reads D zero-padded to DP (64 or 128; the MLA entry
pads q and k to 192 and v to 128).  :func:`emulate`
repeats that arithmetic; the kernel itself runs on the card only.  The
emulation is held against JAX's reference on the same numpy inputs:

* with f32 inputs and p kept in f32, within 2e-5 (the algorithm: tiling,
  folded scale, masks, padding);
* with bf16 inputs and p in bf16, each query row within ``ROW_TOL`` (rms
  of the difference over the row's rms, ``chip_smoke.ROW_TOL``): the
  prediction that 128-key tiles keep the kernel's bf16 rows inside the
  limit the card holds it to;
* a control with one key tile dropped reads above both limits;
* the MLA entry's widths (q.k 192, v 128; and 136 / 72, padded into it)
  hold the same two limits;
* the 64-wide body's 192-row query tiles, at S and T either side of 192
  and 384, hold both limits, and a dropped tile reads above both.
"""
import functools
import importlib.util
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.bench.serve import row_rel_err

ROOT = Path(__file__).resolve().parents[1]
TILE = 128
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
# query rows of the 64-wide body's unit: 64 a consumer warpgroup
ROWS_64 = 64 * int(re.search(r"kConsumers = DQ == 64 \? (\d+) : 2;",
                             SRC.read_text()).group(1))


def _row_tol() -> float:
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.ROW_TOL


ROW_TOL = _row_tol()


def emulate(q, k, v, *, causal=True, bf16=False, drop_tile=None):
    """flash_bf16's arithmetic on (B, S, H, D) q, (B, T, KH, D) k and (B,
    T, KH, Dv) v (f32 tensors holding the inputs' values), a query tile
    at a time (ROWS_64 rows in the 64-wide body, else 128).  ``bf16``
    rounds p before P.V and the output at the end; ``drop_tile`` skips
    one key tile."""
    B, S, H, D = q.shape
    T, KH, Dv = k.shape[1], k.shape[2], v.shape[3]
    DP, DV = ((64, 64) if max(D, Dv) <= 64 else (128, 128)
              if max(D, Dv) <= 128 else (192, 128))
    rows = ROWS_64 if DP == 64 else TILE
    return torch.cat([_emulate_tile(q[:, q0:q0 + rows], k, v, q0, DP, DV,
                                    causal, bf16, drop_tile)
                      for q0 in range(0, S, rows)], dim=1)


def _emulate_tile(q, k, v, q0, DP, DV, causal, bf16, drop_tile):
    """One query tile, rows q0 .. q0 + S - 1, over its key tiles: every
    one, or causal those up to its last row."""
    B, S, H, D = q.shape
    T, KH, Dv = k.shape[1], k.shape[2], v.shape[3]
    pad = (0, DP - D)
    qh = torch.nn.functional.pad(q, pad).transpose(1, 2)       # B H S DP
    kh = torch.nn.functional.pad(k, pad).repeat_interleave(H // KH, 2)
    vh = torch.nn.functional.pad(v, (0, DV - Dv)).repeat_interleave(
        H // KH, 2)
    kh, vh = kh.transpose(1, 2), vh.transpose(1, 2)             # B H T DP
    scale_log2 = torch.tensor(math.log2(math.e) / math.sqrt(D),
                              dtype=torch.float32)
    m = torch.full((B, H, S), -math.inf)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, DV))
    qpos = q0 + torch.arange(S)[:, None]
    kv_end = min(T, q0 + S) if causal else T
    for j in range(-(-kv_end // TILE)):
        if j == drop_tile:
            continue
        k0 = j * TILE
        kpos = torch.arange(k0, min(k0 + TILE, T))[None, :]
        s = qh @ kh[:, :, k0:k0 + TILE].transpose(-1, -2)
        valid = kpos < T
        if causal:
            valid = valid & (kpos <= qpos)
        s = s.masked_fill(~valid, -math.inf)
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        use = torch.where(m_new == -math.inf, 0.0, m_new)
        corr = torch.exp2(m - use)
        p = torch.exp2(s * scale_log2 - use[..., None])
        l = l * corr + p.sum(-1)
        if bf16:
            p = p.to(torch.bfloat16).float()
        acc = acc * corr[..., None] + p @ vh[:, :, k0:k0 + TILE]
        m = m_new
    o = (acc / l.clamp_min(1e-30)[..., None])[..., :Dv].transpose(1, 2)
    return o.to(torch.bfloat16).float() if bf16 else o


@functools.lru_cache(maxsize=None)
def _case(S, T, H, KH, D, causal, bf16, Dv=None):
    """Inputs from numpy (seeded by the shape; bf16 values when ``bf16``)
    as f32 tensors, and JAX's reference output on them; v is Dv wide
    (default D)."""
    rng = np.random.default_rng(S * D if bf16 else S + D)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((1, S, H, D), (1, T, KH, D), (1, T, KH, Dv or D))]
    dt = jnp.bfloat16 if bf16 else jnp.float32
    if bf16:       # round once so both sides get the same bf16 values
        arrs = [np.asarray(jnp.asarray(a, dt), np.float32) for a in arrs]
    want = jref.flash_attention(*(jnp.asarray(a, dt) for a in arrs),
                                causal=causal)
    return ([torch.from_numpy(a) for a in arrs],
            torch.from_numpy(np.array(want, np.float32)))


# (S, T, H, KH, D, causal): S across one, several and many 128-row tiles
# (1000 ragged), GQA, D padded to 64 (24), exactly 64, and 128; then
# non-causal with ragged T
CASES = [(s, s, 2, 1, d, True) for s in (256, 1000, 2048)
         for d in (24, 64, 128)] + [(1000, 1100, 8, 1, 128, False),
                                    (256, 300, 4, 4, 24, False)]
IDS = [f"S{s}-T{t}-H{h}-KH{kh}-D{d}-{'causal' if c else 'full'}"
       for s, t, h, kh, d, c in CASES]


@pytest.mark.parametrize("S,T,H,KH,D,causal", CASES, ids=IDS)
def test_tile_arithmetic_in_f32_matches_jax(S, T, H, KH, D, causal):
    arrs, want = _case(S, T, H, KH, D, causal, False)
    got = emulate(*arrs, causal=causal)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("S,T,H,KH,D,causal", CASES, ids=IDS)
def test_tile_arithmetic_in_bf16_keeps_rows_within_row_tol(S, T, H, KH, D,
                                                           causal):
    arrs, want = _case(S, T, H, KH, D, causal, True)
    got = emulate(*arrs, causal=causal, bf16=True)
    assert torch.isfinite(got).all()
    assert row_rel_err(got, want) <= ROW_TOL


@pytest.mark.parametrize("S,T,H,KH,D,causal", CASES[::4], ids=IDS[::4])
def test_a_dropped_tile_reads_above_both_limits(S, T, H, KH, D, causal):
    drop = -(-T // TILE) // 2
    arrs, want = _case(S, T, H, KH, D, causal, False)
    got = emulate(*arrs, causal=causal, drop_tile=drop)
    assert (got - want).abs().max() > 2e-5
    arrs, want = _case(S, T, H, KH, D, causal, True)
    got = emulate(*arrs, causal=causal, bf16=True, drop_tile=drop)
    assert row_rel_err(got, want) > ROW_TOL


# (S, T, H, KH, D, Dv, causal): the MLA entry across tiles, ragged, and
# non-causal with ragged T; a pair padded into it
MLA_CASES = [(256, 256, 2, 2, 192, 128, True), (1000, 1000, 2, 1, 192, 128,
                                                True),
             (300, 420, 2, 2, 192, 128, False), (500, 500, 2, 2, 136, 72,
                                                 True)]
MLA_IDS = [f"S{s}-T{t}-H{h}-KH{kh}-D{d}-Dv{dv}-{'causal' if c else 'full'}"
           for s, t, h, kh, d, dv, c in MLA_CASES]


@pytest.mark.parametrize("S,T,H,KH,D,Dv,causal", MLA_CASES, ids=MLA_IDS)
def test_mla_tile_arithmetic_matches_jax(S, T, H, KH, D, Dv, causal):
    """f32 within 2e-5; bf16 rows within ROW_TOL; a dropped tile above
    both."""
    arrs, want = _case(S, T, H, KH, D, causal, False, Dv)
    got = emulate(*arrs, causal=causal)
    assert got.shape == (1, S, H, Dv)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    drop = -(-T // TILE) // 2
    assert (emulate(*arrs, causal=causal, drop_tile=drop)
            - want).abs().max() > 2e-5
    arrs, want = _case(S, T, H, KH, D, causal, True, Dv)
    got = emulate(*arrs, causal=causal, bf16=True)
    assert torch.isfinite(got).all()
    assert row_rel_err(got, want) <= ROW_TOL
    assert row_rel_err(emulate(*arrs, causal=causal, bf16=True,
                               drop_tile=drop), want) > ROW_TOL


# (S, T, H, KH, D, causal): the 64-wide body's 192-row query tiles, S and
# T either side of one and two tiles, D 40 padded to 64
WIDE_CASES = [(191, 191, 2, 1, 64, True), (193, 193, 2, 2, 64, True),
              (385, 385, 2, 1, 40, True), (383, 300, 4, 2, 64, False),
              (193, 129, 4, 4, 40, False)]
WIDE_IDS = [f"S{s}-T{t}-H{h}-KH{kh}-D{d}-{'causal' if c else 'full'}"
            for s, t, h, kh, d, c in WIDE_CASES]


@pytest.mark.parametrize("S,T,H,KH,D,causal", WIDE_CASES, ids=WIDE_IDS)
def test_192_row_query_tiles_match_jax(S, T, H, KH, D, causal):
    """f32 within 2e-5; bf16 rows within ROW_TOL; a dropped key tile
    above both."""
    assert ROWS_64 == 192
    arrs, want = _case(S, T, H, KH, D, causal, False)
    torch.testing.assert_close(emulate(*arrs, causal=causal), want,
                               atol=2e-5, rtol=2e-5)
    drop = -(-T // TILE) // 2
    assert (emulate(*arrs, causal=causal, drop_tile=drop)
            - want).abs().max() > 2e-5
    arrs, want = _case(S, T, H, KH, D, causal, True)
    got = emulate(*arrs, causal=causal, bf16=True)
    assert torch.isfinite(got).all()
    assert row_rel_err(got, want) <= ROW_TOL
    assert row_rel_err(emulate(*arrs, causal=causal, bf16=True,
                               drop_tile=drop), want) > ROW_TOL
