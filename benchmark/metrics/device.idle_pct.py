"""device.idle_pct: the share of a step in which no operation runs on the
device, in percent: the traced steps' device-busy time a step (the union
of the profiler's device intervals) against the median wall time of the
window's steps, which run before the profiler slows a step's host work."""

LAYER = "device"
UNIT = "%"
MOVES = "sypd"


def read(record):
    if record.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - record.busy_s / record.steps / record.step_s)
