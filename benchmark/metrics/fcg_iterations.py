"""fcg_iterations: the mean over the window's load cases of the FCG
iterations the program reports (``Solution.stats.iterations``; a
per-case array from ``solve_many``), certification's correction passes
included. A count of the Krylov loop's work a case."""
UNIT = "iterations"
LAYER = "Krylov loop"
MOVES = "solved_dof_per_s"


def read(run):
    its = [i for rec in run.requests for i in rec.iterations]
    return sum(its) / len(its) if its else None
