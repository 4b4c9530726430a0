"""fcg_host_ms_per_case: host milliseconds of the staged FCG loop a load
case that were not spent waiting for the card: the program's
``fea.fcg.run`` spans (the replays and readbacks of a pass, certification's
correction passes included) less their ``fea.fcg.wait`` children (the
waits on a readback's event), summed over the request and divided by its
cases; the median over the window's requests outside the traced slice."""
from benchmark.harness import spans

UNIT = "ms"
LAYER = "Krylov loop"
MOVES = "solved_dof_per_s"


def _host_ms(call):
    runs = call.named("fea.fcg.run")
    waits = [s for run in runs for s in call.children(run) if s.name == "fea.fcg.wait"]
    return (spans.ms(runs) - spans.ms(waits)) / call.record.cases


def read(run):
    return spans.median(run, _host_ms)
