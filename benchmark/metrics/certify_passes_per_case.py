"""certify_passes_per_case: certification's correction passes a load
case, the program's ``fea.certify.pass`` spans counted over the request
and divided by its cases; the median over the window's requests outside
the traced slice. A case whose first FCG lands just above tol shows
here."""
from benchmark.harness import spans

UNIT = "passes"
LAYER = "certification"
MOVES = "solved_dof_per_s"


def read(run):
    return spans.median(run, lambda call: len(call.named("fea.certify.pass")) / call.record.cases)
