"""The bf16 flash kernel's persistent schedule, mirrored in plain Python.

``flash_bf16`` (``src/repro_torch/kernels/csrc/flash_attention.cu``)
launches min(units, SMs) blocks.  Each block's producer thread claims work
units from a counter of its (card, stream) with an atomic add, one unit
ahead, until a claim passes the last unit; unit u is the block u of the
grid the kernel had before it was persistent (``unit_at``: the longest
query tile first, heads fastest unless one batch row's K and V pass half
the L2).  After its one failed claim a block counts itself in a second
word, and the last block to do so sets both back to 0 for the next launch
on the stream.

:func:`unit_at` and :func:`launch` below mirror the C code line by line
(the test reads ``unit_at``'s statements out of the source and compares
them), and :func:`run` plays a launch's claims in the order blocks would
make them (the next claim goes to the block that frees first, each unit
costing its key tiles).  Over glm4's, the MLA's, the three cross paths'
and the ragged sweep shapes, at 132 SMs and at grids smaller than the
unit count and at SM counts above it:

* every unit is claimed exactly once, in today's order (the claims are
  0, 1, 2, ... in time), each block's units increase, and each block
  makes exactly one claim past the last unit;
* unit u's (query tile, head, batch) is today's block u: the longest
  query tile first when causal (n_kt never grows along u within a batch
  row, or within a head when tiles are fastest), heads fastest unless
  K and V pass half the L2;
* the last block to count itself finds every claim made, and leaves both
  words at 0, so launches on one stream chain.
"""
import inspect
import random
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
KTILE = 128
L2_BYTES = 50 << 20


def _consumers_64() -> int:
    m = re.search(r"kConsumers = DQ == 64 \? (\d+) : 2;", SRC.read_text())
    return int(m.group(1))


def unit_rows(D: int, Dv: int) -> int:
    """Query rows a unit (BfLayout::rows): 64 a consumer warpgroup."""
    return 64 * (_consumers_64() if max(D, Dv) <= 64 else 2)


def unit_at(u, n_qt, H, T, causal, tiles_fastest, BM):
    if tiles_fastest:
        qt = u % n_qt
        h = (u // n_qt) % H
        b = u // (n_qt * H)
    else:
        h = u % H
        qt = (u // H) % n_qt
        b = u // (H * n_qt)
    q0 = (n_qt - 1 - qt) * BM
    kv_end = min(T, q0 + BM) if causal else T
    n_kt = (kv_end + KTILE - 1) // KTILE
    return q0, h, b, n_kt


def launch(B, S, T, H, KH, D, Dv, n_sm):
    """(grid, units, unit rows, tiles_fastest) of launch_bf16."""
    BM = unit_rows(D, Dv)
    n_qt = (S + BM - 1) // BM
    n_units = n_qt * H * B
    tiles_fastest = 1 if 2 * KH * T * (D + Dv) > L2_BYTES // 2 else 0
    grid = n_units if n_units < n_sm else n_sm
    return grid, n_units, BM, tiles_fastest


def run(B, S, T, H, KH, D, Dv, causal, n_sm, sched=(0, 0), seed=0):
    """Play one launch's claims from the words ``sched`` (next unit,
    blocks done).  Returns (the claims in time order, each block's units,
    the words after the launch, the claims made when the last block
    counted itself)."""
    grid, n_units, BM, tf = launch(B, S, T, H, KH, D, Dv, n_sm)
    n_qt = (S + BM - 1) // BM
    rng = random.Random(seed)
    sched = list(sched)
    claims, units, at_reset = [], [[] for _ in range(grid)], None
    # (time a block makes its next claim, tie-break, block)
    ready = [(rng.random(), rng.random(), i) for i in range(grid)]
    while ready:
        ready.sort()
        t, _, i = ready.pop(0)
        u, sched[0] = sched[0], sched[0] + 1      # atomicAdd(sched, 1)
        claims.append(u)
        if u >= n_units:                           # index -1: the block ends
            done, sched[1] = sched[1], sched[1] + 1
            if done == grid - 1:
                at_reset = len(claims)
                sched = [0, 0]
            continue
        units[i].append(u)
        n_kt = unit_at(u, n_qt, H, T, causal, tf, BM)[3]
        ready.append((t + n_kt + rng.random(), rng.random(), i))
    return claims, units, tuple(sched), at_reset


def old_block(u, B, S, T, H, KH, D, Dv, causal):
    """(q0, h, b, n_kt) of block u (linear index, x fastest) of the grid
    the kernel launched before it was persistent: dim3(H, n_qt, B), or
    dim3(n_qt, H, B) with tiles fastest, query tile n_qt - 1 - index."""
    BM = unit_rows(D, Dv)
    n_qt = (S + BM - 1) // BM
    tf = 2 * KH * T * (D + Dv) > L2_BYTES // 2
    X, Y = (n_qt, H) if tf else (H, n_qt)
    x, y, z = u % X, (u // X) % Y, u // (X * Y)
    h, qi = (y, x) if tf else (x, y)
    q0 = (n_qt - 1 - qi) * BM
    kv_end = min(T, q0 + BM) if causal else T
    return q0, h, z, -(-kv_end // KTILE)


# (B, S, T, H, KH, D, Dv, causal): glm4's and the MLA's causal layers,
# the three cross paths, units either side of 132 (133 and 263 units, a
# 192-row unit's S either side), and the ragged sweep's shapes
SHAPES = [(1, 8192, 8192, 32, 2, 128, 128, True),
          (1, 8192, 8192, 128, 128, 192, 128, True),
          (1, 8192, 1601, 64, 8, 128, 128, False),
          (16, 1500, 1500, 8, 8, 64, 64, False),
          (16, 448, 1500, 8, 8, 64, 64, False),
          (1, 100, 300, 133, 7, 64, 64, False),
          (1, 100, 300, 263, 263, 64, 64, False),
          (1, 180, 180, 133, 19, 64, 64, True),
          (1, 250, 250, 131, 131, 128, 128, True),
          (2, 191, 191, 4, 2, 64, 64, True),
          (2, 193, 250, 4, 2, 64, 64, False),
          (1, 385, 385, 8, 1, 40, 40, True),
          (1, 1, 1, 16, 16, 192, 128, True),
          (2, 257, 257, 32, 2, 128, 128, True),
          (1, 1000, 1000, 128, 128, 192, 128, True),
          (1, 2048, 2048, 64, 32, 128, 128, True)]
IDS = ["glm4", "mla", "vlm_cross", "whisper_encoder", "whisper_cross",
       "units133", "units263", "causal133", "causal131", "S191", "S193",
       "S385", "one_row", "S257", "mla1000", "tiles_fastest"]


@pytest.mark.parametrize("n_sm", [132, 7, 1 << 20])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_every_unit_once_in_today_s_order(shape, n_sm):
    B, S, T, H, KH, D, Dv, causal = shape
    grid, n_units, BM, tf = launch(B, S, T, H, KH, D, Dv, n_sm)
    assert grid == min(n_units, n_sm) >= 1
    claims, units, sched, at_reset = run(*shape, n_sm)
    # one claim a unit, in order, then one failed claim a block; the last
    # block to count itself comes after every claim, and leaves 0, 0
    assert claims[:n_units] == list(range(n_units))
    assert len(claims) == n_units + grid
    assert all(c >= n_units for c in claims[n_units:])
    assert at_reset == len(claims) and sched == (0, 0)
    assert sorted(u for us in units for u in us) == list(range(n_units))
    assert all(us == sorted(us) for us in units)
    # unit u is today's block u
    n_qt = (S + BM - 1) // BM
    got = [unit_at(u, n_qt, H, T, causal, tf, BM) for u in range(n_units)]
    assert got == [old_block(u, *shape) for u in range(n_units)]
    assert {(q0, h, b) for q0, h, b, _ in got} == {
        (q0, h, b) for q0 in range(0, n_qt * BM, BM) for h in range(H)
        for b in range(B)}
    # the longest query tile first; heads fastest unless K, V pass L2 / 2
    assert bool(tf) == (2 * KH * T * (D + Dv) > L2_BYTES // 2)
    for b in range(B):
        for h in range(H):
            mine = [n for q0, hh, bb, n in got if bb == b and (hh == h
                                                              or not tf)]
            assert mine == sorted(mine, reverse=True)
    if not tf:
        assert [h for _, h, _, _ in got[:H]] == list(range(H))
    assert max(n for *_, n in got) == -(-(min(T, n_qt * BM) if causal
                                           else T) // KTILE)


def test_launches_on_one_stream_chain():
    sched = (0, 0)
    for i, shape in enumerate(SHAPES[3:8]):
        claims, _, sched, _ = run(*shape, 132, sched=sched, seed=i)
        grid, n_units, _, _ = launch(*shape[:7], 132)
        assert claims[:n_units] == list(range(n_units)) and sched == (0, 0)


def test_the_mirror_is_the_source_s_unit_at():
    """unit_at's statements in the CUDA source, in order, against the
    mirror's: `w.` dropped, `/` for `//`, `kTile` for KTILE, ternaries
    and `if/else` compared as the mirror writes them."""
    text = SRC.read_text()
    body = re.search(r"Unit unit_at\(int u,[^{]*\{(.*?)\n\}", text,
                     re.S).group(1)
    c_stmts = [re.sub(r"\s+", " ", s).strip()
               for s in re.findall(r"(\w[^;{}]*?=[^;]*);", body)]
    want = ["qt = u % n_qt", "w.h = (u / n_qt) % H", "w.b = u / (n_qt * H)",
            "w.h = u % H", "qt = (u / H) % n_qt", "w.b = u / (H * n_qt)",
            "w.q0 = (n_qt - 1 - qt) * BM",
            "const int kv_end = causal ? min(T, w.q0 + BM) : T",
            "w.n_kt = (kv_end + kTile - 1) / kTile"]
    assert c_stmts == want
    py = inspect.getsource(unit_at)
    for stmt in want:
        p = (stmt.replace("w.", "").replace("const int ", "")
             .replace(" / ", " // ").replace("kTile", "KTILE"))
        if "?" in p:
            p = "kv_end = min(T, q0 + BM) if causal else T"
        assert p in py, p
    assert "const int tiles_fastest =\n      2ll * KH * T * (D + Dv) > " \
           "kL2Bytes / 2 ? 1 : 0;" in text
    assert "const int grid = n_units < n_sm ? n_units : n_sm;" in text
    assert "if (atomicAdd(sched + 1, 1u) == gridDim.x - 1) {" in text
