"""curv_build_ms_per_request: host milliseconds a request spent in the
curvilinear build's stages on the card, the program's
``fea.build.curv.jacobians`` (the check of the least Jacobian
determinant), ``fea.build.curv.weights`` (the weight field's assembly),
``fea.build.curv.rap`` (one Galerkin level each, the launches of its
card work), ``fea.build.curv.levels`` (each level's Gershgorin bound and
cast, whose first read waits for the RAP chain's card work) and
``fea.build.curv.coarse`` (the coarsest level's dense matrix on the host,
its inverse and upload) spans, summed over the request; the median over
the window's requests outside the traced slice. Each span ends on the
host, and the card's work it launched may finish inside the next one that
waits for the card: the sum, not each part, is the build's time. None where no
request of the window opened any of them (a program without these spans,
or a window whose every request took a cached build)."""
import statistics

from benchmark.harness import spans

UNIT = "ms"
LAYER = "curvilinear build"
MOVES = "solved_dof_per_s"
NAMES = ("fea.build.curv.jacobians", "fea.build.curv.weights", "fea.build.curv.rap", "fea.build.curv.levels",
         "fea.build.curv.coarse")


def read(run):
    found = spans.calls(run)
    if found is None or not any(s.name in NAMES for call in found for s in call.spans):
        return None
    return statistics.median(sum(call.ms(name) for name in NAMES) for call in found)
