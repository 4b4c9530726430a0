"""The f32 roofline of K4 on 14 of 27 blocks at 811,923 DOF, the bound
f32_apply_roofline.curv reads against (chip_smoke.py's arithmetic)."""
from __future__ import annotations

import pytest

from benchmark.harness import roofline

CURV = [40, 40, 160]


@pytest.mark.parametrize("masked,ms", [
    (False, 0.0412),  # K4 14-block, the kernel table's bound
    (True, 0.0422),   # K4 14-block, masked (the V-cycle's finest level)
])
def test_f32_var_bounds(masked, ms):
    """Half the f64 bytes: 4-byte values, and the operations at 67
    TFLOP/s stay under the bytes' time."""
    t, by = roofline.var_apply(CURV, "float32", masked)
    assert by == "bytes" and round(t * 1e3, 4) == ms
    assert t == pytest.approx(roofline.var_apply(CURV, "float64", masked)[0] / 2, rel=1e-12)
