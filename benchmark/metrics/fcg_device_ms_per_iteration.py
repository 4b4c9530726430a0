"""fcg_device_ms_per_iteration: milliseconds the card was busy in the
traced slice (the union of its kernels', copies' and sets' intervals,
``trace.busy_s``) over the FCG iterations the slice's requests report
(``Solution.stats.iterations``, certification's correction passes
included). The device time of one iteration with its share of the
request's other card work (the loads, certification's residual). None
where no device ran anything in the slice, or no iteration was reported."""
UNIT = "ms"
LAYER = "Krylov loop"
MOVES = "solved_dof_per_s"


def read(run):
    t = run.trace
    its = sum(i for rec in run.requests if rec.profiled for i in rec.iterations)
    return None if t is None or t.busy_s <= 0 or its <= 0 else 1e3 * t.busy_s / its
