"""extruded_apply_launches_per_iteration: launches of the extruded
operator's apply kernel E a staged FCG step on the extruded route: the
program's counter ``ops.cuda_extruded.LAUNCHES`` (``apply_f32`` plus
``apply_f64``, one a launch, masked or raw) over its
``solve.staged.COUNTS["steps"]`` (graph replays on a card, eager steps on
the CPU), both process totals read after the window through
``sys.modules``, as the client reads ``staged.COUNTS``. A replay is
credited with its captured step's launches; a capture's eager warm-up
step, the right-hand side and certification launch outside any step, so
the ratio lies just above one step's count on a card. None on a program
without the counter or with no step."""
import sys

UNIT = "launches"
LAYER = "kernels"
MOVES = "solved_dof_per_s"
COUNTER = "fea_tpu_torch.ops.cuda_extruded"
STAGED = "fea_tpu_torch.solve.staged"


def read(run):
    launches = getattr(sys.modules.get(COUNTER), "LAUNCHES", None)
    counts = getattr(sys.modules.get(STAGED), "COUNTS", {})
    steps = counts.get("steps")
    if not launches or not steps:
        return None
    return (launches.get("apply_f32", 0) + launches.get("apply_f64", 0)) / steps
