"""mesh.gathers: the launches a step of NCCL's all-gather kernels (the
rows whose name holds ``AllGather``): every rendezvous of all the ranks
inside a step, which a decomposed step without collectives does not
make.  0 where the trace holds device work and no all-gather."""

LAYER = "mesh"
UNIT = "launches/step"
MOVES = "sypd"


def read(record):
    if not record.device_rows:
        return None
    n = sum(c for name, _t, c in record.device_rows
            if "nccl" in name.lower() and "AllGather" in name)
    return n / record.steps
