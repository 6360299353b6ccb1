"""The harness on the card at a tiny size: each cell's traced run is
correct and reads every per-layer metric its cell lists, with shares of
the roofline and of the window inside 0-100.  Run on the card with
`python -m pytest port_bench/tests -m card`; skips without one."""
import sys

import pytest

from _tiny import REPO, SEED, tiny

sys.path.insert(0, str(REPO / "port_bench"))
import run  # noqa: E402


@pytest.mark.card
@pytest.mark.parametrize("workload", ["ssb_flat_sf10.power_c1"])
def test_traced_run_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch sees no CUDA device")
    cell = tiny(workload)
    res = run.run_cell(cell, SEED, 2.0, 1)
    assert res["correct"] is True, res["compared"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert {m["name"] for m in cell.per_layer} == set(res["metrics"])
    for name in ("fused_scan.roofline_pct", "device.idle_pct"):
        if name in res["metrics"]:
            assert 0 < res["metrics"][name]["value"] <= 100, (name, res["metrics"][name])
