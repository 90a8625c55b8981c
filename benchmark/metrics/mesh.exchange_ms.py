"""mesh.exchange_ms: the device time a step of NCCL's point-to-point
kernels (the ``ncclDevKernel_SendRecv`` rows): the mesh's halo exchanges,
with the time each kernel spends waiting for the neighbouring rank to
post its side, which NCCL spends inside the kernel."""

LAYER = "mesh"
UNIT = "ms/step"
MOVES = "sypd"


def read(record):
    s = sum(t for name, t, _c in record.device_rows
            if "nccl" in name.lower() and "SendRecv" in name)
    return 1e3 * s / record.steps if s > 0.0 else None
