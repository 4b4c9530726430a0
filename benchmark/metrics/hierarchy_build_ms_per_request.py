"""hierarchy_build_ms_per_request: host milliseconds a request spent
building its preconditioner, the program's ``fea.build.hierarchy`` spans
(on the voxel route ``build_multigrid``: the levels built on the host and
uploaded), summed over the request; the median over the window's requests
outside the traced slice."""
from benchmark.harness import spans

UNIT = "ms"
LAYER = "hierarchy build"
MOVES = "solved_dof_per_s"


def read(run):
    return spans.median(run, lambda call: call.ms("fea.build.hierarchy"))
