"""step.host_syncs: synchronising operations (host reads of device
values, device-to-host copies, stream synchronisations) that
``torch.cuda.set_sync_debug_mode("warn")`` reported over the traced
steps, a step."""

LAYER = "model step"
UNIT = "syncs/step"
MOVES = "sypd"


def read(record):
    if not record.device_rows:
        return None
    return record.syncs / record.steps
