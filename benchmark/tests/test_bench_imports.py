"""What the benchmark runs imports neither JAX nor the JAX package
``fea_tpu`` (top-level module names compared whole: ``fea_tpu_torch``
begins with ``fea_tpu``), the reference imports nothing of the program,
and a run without a CUDA card exits non-zero and prints no result."""
from __future__ import annotations

import os
import subprocess
import sys

from benchmark.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "fea_tpu"}


def _top_level_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=tiny.REPO, capture_output=True, text=True, timeout=600,
                         env=os.environ | {"PYTHONPATH": str(tiny.REPO)})
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_imports_no_jax(tmp_path):
    root = tiny.checkout(tmp_path)
    mods = _top_level_after(
        "import torch\ntorch.set_num_threads(1)\nfrom pathlib import Path\nfrom benchmark.tests import tiny\n"
        f"assert tiny.run(Path({str(root)!r}), 'tiny_voxel.batch8', trace=1)[0] == 0\n"
        f"assert tiny.run(Path({str(root)!r}), 'tiny_curv.loadcases')[0] == 0")
    assert "fea_tpu_torch" in mods and not mods & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    mods = _top_level_after("import benchmark.reference.check, benchmark.reference.control")
    assert not mods & (FORBIDDEN | {"fea_tpu_torch"})


def test_no_card_no_result(tmp_path):
    root = tiny.checkout(tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "voxel_1m.batch8", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=root, capture_output=True, text=True, timeout=600,
                         env=os.environ | {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""
