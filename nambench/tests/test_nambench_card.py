"""On the card only (``gpu``): every cell of the small copy runs its
traced slice, reports every per-layer metric it lists, and keeps each
roofline share at or under 100 %."""
import pytest
import torch

from nambench.harness import run_cell

CELLS = ("olap-join-mix", "oltp-checkout", "olap-agg-large-g",
         "oltp-checkout-zipf")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_every_metric(small, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    res = run_cell(small, cell, 5, 0.5, True)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0
    want = {m.name for m in small.per_layer_of(cell)}
    assert set(res["metrics"]) == want
    for name, m in res["metrics"].items():
        if name.endswith("_roofline_pct.query"):
            assert 0 < m["value"] <= 100
