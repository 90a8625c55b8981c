"""phases.device_ms: device time of everything but the four hand-written
kernels (the eager column phases, the EVP's and remap's eager parts,
the forcing's and the coupler's device work), a step."""

from counts.kernels import kernel_of

LAYER = "eager phases"
UNIT = "ms/step"
MOVES = "sypd"


def read(record):
    eager = sum(s for name, s, _c in record.device_rows
                if kernel_of(name) is None)
    return 1e3 * eager / record.steps if eager > 0 else None
