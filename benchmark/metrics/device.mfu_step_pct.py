"""device.mfu_step_pct: the whole step's share of the card's peak: the
least time a step could take (its state, grid, forcing and fluxes moved
once, against its counted operations, ``counts/kernels.py``) over the
median wall time of the window's steps (run before the profiler is
attached), in percent.  It reads the same work whatever implements the
step."""

LAYER = "device"
UNIT = "%"
MOVES = "sypd"


def read(record):
    if not record.device_rows:
        return None
    return 100.0 * record.step_bound_ms / (1e3 * record.step_s)
