"""operator_build_ms_per_request: host milliseconds a request spent
building its operator, the program's ``fea.build.operator`` spans (on the
voxel route ``build_structured_operator``: the box validated again and
the one host Ke), summed over the request; the median over the window's
requests outside the traced slice."""
from benchmark.harness import spans

UNIT = "ms"
LAYER = "operator build"
MOVES = "solved_dof_per_s"


def read(run):
    return spans.median(run, lambda call: call.ms("fea.build.operator"))
