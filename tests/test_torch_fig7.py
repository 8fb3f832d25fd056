"""Fig 7 in the port (``repro_torch.bench.fig7_costmodel``) against the
JAX benchmark (``benchmarks/fig7_costmodel.py``): every row (names,
values, derived strings), the crossover, the profiles and, under
``timed``, the measured key are equal, over the default profile axis and
for single profiles (where the axis-flip assert does not apply)."""
import pytest

from benchmarks import fig7_costmodel as jfig7
from repro_torch.bench import fig7_costmodel as fig7


@pytest.mark.parametrize("profiles", [None, ("rdma_edr",), ("ipoib_fdr",),
                                      ("ethernet_1g", "rdma_fdr4x")],
                         ids=["default", "rdma_edr", "ipoib_fdr", "pair"])
def test_rows_and_crossover_equal_jax(profiles):
    rows, extras = fig7.run(profiles, timed=True)
    jrows, jextras = jfig7.run(profiles, timed=True)
    assert rows == jrows
    assert extras["crossover"] == jextras["crossover"]
    assert extras["profiles"] == jextras["profiles"]
    assert set(extras["measured_s"]) == set(jextras["measured_s"])
    assert rows[-1] == ("fig7/claims", 0.0, "all_hold")


def test_the_default_axis_flips_the_planner():
    _, extras = fig7.run()
    assert any(len(set(w.values())) > 1
               for w in extras["crossover"].values())
    assert len(extras["crossover"]) == len(fig7.SELS)
