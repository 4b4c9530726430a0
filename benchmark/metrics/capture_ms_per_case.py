"""capture_ms_per_case: host milliseconds the staged FCG spent capturing
its CUDA graphs (the program's counter ``staged.COUNTS["capture_ms"]``,
read around each request), over the load cases of the window's requests
outside the traced slice, where the profiler would slow the capture."""
UNIT = "ms"
LAYER = "Krylov loop"
MOVES = "solved_dof_per_s"


def read(run):
    recs = [rec for rec in run.requests if not rec.profiled and rec.capture_ms is not None]
    cases = sum(rec.cases for rec in recs)
    return sum(rec.capture_ms for rec in recs) / cases if cases else None
