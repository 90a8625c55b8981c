"""The traced part of a run: a profiler over a few steps after the
window, with PyTorch's synchronisation warnings counted beside it,
reduced to the record that the per-layer metric readers take.

Spans are the benchmark's own, around its calls into the program: one
``record_function`` span per step; the program has none of its own yet.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import warnings

import numpy as np
import torch

# the benchmark's span around each traced step
SPAN = "benchmark.step"


@dataclasses.dataclass
class TraceRecord:
    """What the readers of the per-layer metrics take.

    steps, wall_s: the traced steps and their wall time (the sum of the
    steps' host-clock times, each ending in a device synchronisation);
    step_s: the median host-clock time of the window's steps, which run
    before the profiler is attached (it slows a step's host work);
    wait_s: on a run of several ranks, this rank's mean time a window
    step in the all-reduce that ends it, the wait for the other ranks
    (None on one process);
    device_rows: [(name, device seconds, launches)] of every device
    operation; busy_s: the union of the device's busy intervals;
    syncs: synchronising operations PyTorch reported; forcing_s: the
    driver's "Forcing" timer over the traced steps (None where the entry
    has no such timer); kernel_bound_ms: {kernel: bound of one launch};
    step_bound_ms: the bound of one whole step; breakdown: the top device
    operations and idle gaps."""

    steps: int
    wall_s: float
    step_s: float
    device_rows: list
    busy_s: float
    syncs: int
    sync_sites: list
    forcing_s: float | None
    kernel_bound_ms: dict
    step_bound_ms: float
    breakdown: dict
    wait_s: float | None = None


class Tracer:
    """Profile the steps run between entering and leaving it."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self._stack = contextlib.ExitStack()
        self.prof = None
        self.caught = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self.caught = self._stack.enter_context(
            warnings.catch_warnings(record=True))
        warnings.simplefilter("always")
        self.prof = self._stack.enter_context(profile(activities=activities))
        if self.cuda:
            torch.cuda.set_sync_debug_mode("warn")
            self._stack.callback(torch.cuda.set_sync_debug_mode, "default")
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        return self._stack.__exit__(*exc)

    def reduce(self, wall_s: float, steps: int, step_s: float, forcing_s,
               kernel_bound_ms, step_bound_ms) -> TraceRecord:
        events = self.prof.profiler.kineto_results.events()
        dev, cpu = [], []
        for e in events:
            kind = str(e.device_type())
            if e.name() == SPAN or _annotation(e):
                continue      # the benchmark's own spans, not device work
            if kind.endswith("CUDA"):
                dev.append((e.name(), e.start_ns(), e.duration_ns()))
            elif kind.endswith("CPU"):
                cpu.append((e.name(), e.start_ns(), e.duration_ns()))
        rows = collections.defaultdict(lambda: [0.0, 0])
        for name, _s, d in dev:
            rows[name][0] += d * 1e-9
            rows[name][1] += 1
        device_rows = [(n, v[0], v[1]) for n, v in rows.items()]
        merged = _merge([(s, s + d) for _n, s, d in dev])
        busy_s = sum(b - a for a, b in merged) * 1e-9
        sites = collections.Counter(
            f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"
            for w in self.caught if "synchroniz" in str(w.message))
        top_ops = sorted(device_rows, key=lambda r: -r[1])[:10]
        breakdown = {"device_ops": [[n, s] for n, s, _c in top_ops],
                     "idle_gaps": _idle_gaps(merged, cpu)}
        return TraceRecord(
            steps=steps, wall_s=wall_s, step_s=step_s, device_rows=device_rows,
            busy_s=busy_s, syncs=sum(sites.values()),
            sync_sites=sites.most_common(10), forcing_s=forcing_s,
            kernel_bound_ms=kernel_bound_ms, step_bound_ms=step_bound_ms,
            breakdown=breakdown)


def _annotation(e) -> bool:
    """Whether a profiler event is a span (a user annotation) and not an
    operation: PyTorch versions name this in different ways."""
    if getattr(e, "is_user_annotation", None) and e.is_user_annotation():
        return True
    kind = getattr(e, "activity_type", None)
    kind = kind() if callable(kind) else kind
    return "annotation" in str(kind).lower()


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _idle_gaps(merged, cpu, longest: int = 500):
    """The idle time of the longest gaps between the device's busy
    intervals, summed by what the host was doing at each gap's middle:
    the innermost profiled host operation then running.  At most ten
    [name, seconds] pairs, the largest first."""
    if len(merged) < 2 or not cpu:
        return []
    a = np.array([m[0] for m in merged[1:]], dtype=np.int64)
    b = np.array([m[1] for m in merged[:-1]], dtype=np.int64)
    length = a - b
    order = np.argsort(-length)[:longest]
    names = [c[0] for c in cpu]
    start = np.array([c[1] for c in cpu], dtype=np.int64)
    dur = np.array([c[2] for c in cpu], dtype=np.int64)
    end = start + dur
    by = collections.defaultdict(float)
    for k in order:
        mid = (a[k] + b[k]) // 2
        inside = np.nonzero((start <= mid) & (end >= mid))[0]
        label = names[inside[np.argmin(dur[inside])]] if inside.size \
            else "(no host operation)"
        by[label] += float(length[k]) * 1e-9
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:10]]
