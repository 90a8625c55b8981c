"""mesh.wait_ms: this rank's mean wait a window step, in ms, in the
harness's all-reduce that ends each step on several ranks: how long the
rank stood still for the slowest rank of the step."""

LAYER = "mesh"
UNIT = "ms/step"
MOVES = "sypd"


def read(record):
    if record.wait_s is None:
        return None
    return 1e3 * record.wait_s
