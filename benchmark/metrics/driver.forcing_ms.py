"""driver.forcing_ms: the driver's "Forcing" timer (``timers.Timers``,
which synchronises at the region's end) over the traced steps, a step.
The forcing readers' host work and the forcing's device work."""

LAYER = "driver"
UNIT = "ms/step"
MOVES = "sypd"


def read(record):
    if record.forcing_s is None:
        return None
    return 1e3 * record.forcing_s / record.steps
