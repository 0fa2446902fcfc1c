"""chip_smoke.py's per-lane scene-cotangent comparison, with the kernel in
Pallas' interpret mode on the CPU: every lane agrees and the totals match.
(On the GPU the same function compares the compiled kernel; the refusal of
chip_smoke.py to run without a GPU is in tests/test_routes.py.)"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("w, h, spp, seed", [(40, 8, 2, 0), (33, 5, 1, 1)])
def test_grad_lanes_interpret(w, h, spp, seed):
    rec = chip_smoke.grad_lanes(w, h, spp, 3, seed, interpret=True)
    assert rec["lanes"] == w * h
    assert rec["lane_agree_share"] == 1.0
    for key in ("total_all_lanes", "total_agreeing_lanes",
                "xla_forward_vs_reverse_total"):
        assert max(rec[key].values()) < 1e-5, (key, rec[key])
