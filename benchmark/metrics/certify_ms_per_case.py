"""certify_ms_per_case: host milliseconds a load case spent in
certification, the program's ``fea.certify`` spans (``refine_true``: the
true f64 residual and any correction passes), summed over the request and
divided by its cases; the median over the window's requests outside the
traced slice."""
from benchmark.harness import spans

UNIT = "ms"
LAYER = "certification"
MOVES = "solved_dof_per_s"


def read(run):
    return spans.median(run, lambda call: call.ms("fea.certify") / call.record.cases)
