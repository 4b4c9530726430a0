"""fcg_iterations.curv: ``fcg_iterations`` in the curvilinear cells: the
mean over the window's load cases of the FCG iterations the program
reports, certification's correction passes included."""
from pathlib import Path

from benchmark.harness import spec

UNIT = "iterations"
LAYER = "Krylov loop"
MOVES = "solved_dof_per_s"

read = spec.load_module(Path(__file__).with_name("fcg_iterations.py")).read
