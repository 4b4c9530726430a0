"""route_ms_per_request: host milliseconds a request spent routing, the
program's ``fea.route`` spans (the grid detectors of ``_grid_route``:
the voxel box's O(N) validation, the extruded and curvilinear tests),
summed over the request; the median over the window's requests outside
the traced slice."""
from benchmark.harness import spans

UNIT = "ms"
LAYER = "routing"
MOVES = "solved_dof_per_s"


def read(run):
    return spans.median(run, lambda call: call.ms("fea.route"))
