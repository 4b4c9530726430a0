"""The result line: its keys, the metrics of each mode, the numbers
judged last beside their limits, and the same numbers as the last lines
of standard error."""
from __future__ import annotations

import pytest
import torch

from benchmark.reference import check
from benchmark.tests import tiny

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(root, trace):
    rc, lines, err = tiny.run(root, "tiny_curv.loadcases", trace=trace)
    res = tiny.result(lines)
    assert rc == 0 and list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert res["device"]["window_s"] > 0 and set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in res["breakdown"].values())
    else:
        assert set(res["metrics"]) == {"solved_dof_per_s", "request_s_p95", "peak_device_gb", "setup_s"}
        assert all(m["value"] > 0 for k, m in res["metrics"].items() if k != "peak_device_gb")
    assert set(res["checks"]) == set(check.NAMES)
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    tail = err.strip().splitlines()[-len(check.NAMES):]
    assert [t.split(":")[0] for t in tail] == [f"check {n}" for n in check.NAMES]


def test_sample_is_drawn_from_the_seed(root):
    """The same seed judges the same requests: the numbers repeat."""
    a = tiny.result(tiny.run(root, "tiny_voxel.batch8", seed=7)[1])["checks"]
    b = tiny.result(tiny.run(root, "tiny_voxel.batch8", seed=7)[1])["checks"]
    assert a == b
