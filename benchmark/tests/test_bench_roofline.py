"""The frozen roofline arithmetic against the bounds PERF.md's kernel
table gives (chip_smoke.py's arithmetic): K2 at 1,048,707 DOF, K5 on 14
of 27 blocks at 811,923 DOF."""
from __future__ import annotations

import pytest

from benchmark.harness import roofline

VOXEL = [32, 32, 320]
CURV = [40, 40, 160]


@pytest.mark.parametrize("cells,fn,masked,ms", [
    (VOXEL, roofline.voxel_apply, False, 0.0050),   # K2 raw, 1M
    (VOXEL, roofline.voxel_apply, True, 0.0075),    # K2 masked, 1M
    (CURV, roofline.var_apply, False, 0.0825),      # K5 14-block
    (CURV, roofline.var_apply, True, 0.0844),       # K5 14-block, masked (the FCG apply)
])
def test_f64_bounds(cells, fn, masked, ms):
    t, by = fn(cells, "float64", masked)
    assert by == "bytes" and round(t * 1e3, 4) == ms


def test_share_reads_the_finest_launches():
    from benchmark.harness.trace import Trace

    t = Trace(kernels=[("k<double, true>", 40.0, 900), ("k<double, true>", 44.0, 900), ("k<double, true>", 3.0, 20),
                       ("other", 100.0, 900)], busy_s=0.0, window_s=1.0, breakdown={})
    assert roofline.share(t, "k<double, true", 21e-6) == pytest.approx(50.0)
    assert roofline.share(t, "absent", 1e-6) is None
