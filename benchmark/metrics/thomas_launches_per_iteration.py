"""thomas_launches_per_iteration: the block-Thomas sweeps' matrix-vector
launches a staged FCG step on the extruded route: the program's counter
``ops.extruded_mg.LAUNCHES["thomas"]`` (one an ``addmv_``) over its
``solve.staged.COUNTS["steps"]`` (graph replays on a card, eager steps on
the CPU), both process totals read after the window through
``sys.modules``, as the client reads ``staged.COUNTS``. A replay is
credited with its captured step's launches; a capture's eager warm-up step
counts once, outside any step, so the ratio lies just above one step's
count on a card. None on a program without the counter or with no step."""
import sys

UNIT = "launches"
LAYER = "V-cycle"
MOVES = "solved_dof_per_s"
COUNTER = "fea_tpu_torch.ops.extruded_mg"
STAGED = "fea_tpu_torch.solve.staged"


def read(run):
    launches = getattr(sys.modules.get(COUNTER), "LAUNCHES", {}).get("thomas")
    counts = getattr(sys.modules.get(STAGED), "COUNTS", {})
    steps = counts.get("steps")
    return None if launches is None or not steps else launches / steps
