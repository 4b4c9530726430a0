"""Run a cell with a control in the program's place (``reference/control.py``):
``f32``, the plain reference in float32, or ``rounded``, the program's
answers rounded to float32. Its run has to print ``"correct": false``;
its numbers are the upper readings the limits are set below.

    python3 benchmark/control.py --control <f32|rounded> --workload <cell> --seed <n> --seconds <s> --trace 0

The benchmark's own runs never run it. ``f32`` runs no warm-up requests:
it compiles nothing, and each of its requests takes seconds.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import run  # noqa: E402
from benchmark.reference import control  # noqa: E402

if __name__ == "__main__":
    p = argparse.ArgumentParser(description="Run a cell with a control in the program's place.")
    p.add_argument("--control", choices=("f32", "rounded"), required=True)
    ns, rest = p.parse_known_args()
    if ns.control == "f32":
        sys.exit(run.main(rest, device="cuda", api=control, warmup=0))
    import fea_tpu_torch

    sys.exit(run.main(rest, api=control.Rounded(fea_tpu_torch)))
