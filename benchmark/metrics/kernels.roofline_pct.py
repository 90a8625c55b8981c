"""kernels.roofline_pct: the four hand-written kernels' summed bound
(``counts/kernels.py``, each launch's bytes and operations from the
cell's shapes and initial state against the card's peaks) over their
summed device time, in percent.  Only the kernels that ran count."""

import collections

from counts.kernels import kernel_of

LAYER = "kernels"
UNIT = "%"
MOVES = "sypd"


def read(record):
    time_s = collections.defaultdict(float)
    launches = collections.Counter()
    for name, s, count in record.device_rows:
        k = kernel_of(name)
        if k is not None:
            time_s[k] += s
            launches[k] += count
    total = sum(time_s.values())
    if total <= 0.0:
        return None
    bound_s = sum(1e-3 * record.kernel_bound_ms[k] * launches[k]
                  for k in time_s)
    return 100.0 * bound_s / total
