"""step.launches: device operations (kernels, copies, fills) the
profiler saw over the traced steps, a step."""

LAYER = "model step"
UNIT = "launches/step"
MOVES = "sypd"


def read(record):
    n = sum(count for _name, _s, count in record.device_rows)
    return n / record.steps if n else None
