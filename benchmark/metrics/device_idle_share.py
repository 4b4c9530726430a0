"""device_idle_share: percent of the traced slice's wall in which no
kernel, copy or set ran on the card: 1 - (the union of the device's
activity intervals) / (the slice's length), both from the same profiled
run."""
UNIT = "%"
LAYER = "device"
MOVES = "solved_dof_per_s"


def read(run):
    t = run.trace
    return None if t is None or t.window_s <= 0 else 100.0 * (1.0 - t.busy_s / t.window_s)
