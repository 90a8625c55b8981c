"""Hierarchical named wall-clock timers.

Port of :mod:`cice4_tpu.timers` (``mpi/ice_timers.F90:36-79``: the
standard timers such as Step, ReadWrite, Diags and History, with the
printed report at finalize).  PyTorch queues device work and returns, so
a timer given a CUDA device synchronises it at the end of each region:
"Step" is then the step's wall time, not the time to enqueue it.  For
the device time of the phases inside a step, use ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Timers:
    def __init__(self, device=None):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._start = time.time()
        self._sync = (device is not None
                      and torch.device(device).type == "cuda")
        self._device = device

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            if self._sync:
                torch.cuda.synchronize(self._device)
            self.totals[name] += time.time() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["Timing information:"]
        total = time.time() - self._start
        lines.append(f"  {'Total':12s} {total:12.3f} s")
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {name:12s} {t:12.3f} s   ({self.counts[name]}x)")
        return "\n".join(lines)
