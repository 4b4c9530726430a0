"""certify_passes_per_case.curv: ``certify_passes_per_case`` in the
curvilinear cells: certification's correction passes a load case (the
program's ``fea.certify.pass`` spans), the median over the window's
requests outside the traced slice."""
from pathlib import Path

from benchmark.harness import spec

UNIT = "passes"
LAYER = "certification"
MOVES = "solved_dof_per_s"

read = spec.load_module(Path(__file__).with_name("certify_passes_per_case.py")).read
