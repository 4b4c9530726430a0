"""solve_self_ms_per_request: host milliseconds of a request's root span
(``fea.solve`` or ``fea.solve_many``) that none of its direct children
covers: what no stage's span holds (argument checks, copies between the
stages, the cases' start, the result's assembly); the median over the
window's requests outside the traced slice."""
from benchmark.harness import spans

UNIT = "ms"
LAYER = "entry"
MOVES = "solved_dof_per_s"


def read(run):
    return spans.median(run, spans.self_ms)
