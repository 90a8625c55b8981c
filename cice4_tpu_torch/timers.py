"""CICE's standard timers as nested spans.

Port of :mod:`cice4_tpu.timers` (``mpi/ice_timers.F90:36-79``: the
standard timers Total, Step, Dynamics, Advection, Column, Thermo,
Shortwave, Ridging, CatConv, Coupling, ReadWrite, Diags, History, Bound,
with the printed report at finalize).

A region is named by its path: a region opened inside "Step" as
``span("Thermo")`` is ``Step/Thermo``.  Every region adds its host time
(``time.perf_counter_ns``) and a count.  Code below the driver opens
spans with :func:`span`, which times them on the `Timers` whose
outermost region is open on this thread, and does nothing where none is
(a bare `Model`, a block thread of a decomposed run); :func:`count` adds
to that `Timers`' counters alike, a Python int or a 0-d device tensor
(the ridging passes on a card), which is kept on the device and read
only when `counters` or `report()` is.

Nothing here waits for the device while regions run.  On a CUDA device
an outermost region (Init, Forcing, Step, History, Diags, ReadWrite; the
component's Receive, Step, History, Send) records a CUDA event at its
start and at its end; its total is the larger of its host time and the
device time between the two events: from its start to the device
finishing the work it queued, as when each region ended in a
synchronisation, without waiting for work queued before it.  Pairs whose
end has passed (``Event.query``) are resolved as regions close; the rest
are resolved, waiting for the device, only when `totals` or `report()`
is read.  Inner regions count host time only.  On the CPU everything is
host time.

On a decomposed grid every neighbour exchange of the mesh is a region
``Exchange`` under the phase that makes it (``Step/Dynamics/Exchange``,
``Step/Dynamics/Advection/Exchange``), and the counters ``exchanges``
and ``collectives`` count a run's exchanges and its all-gathers
(:mod:`cice4_tpu_torch.parallel.mesh`).

While a ``torch.profiler`` records, each region also opens a
``torch.profiler.record_function`` span of its path, so that the
program's spans sit on the trace's own clock beside the device's
operations; without one no span is made.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

_local = threading.local()
_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A region `name` of the `Timers` active on this thread, or a
    context that does nothing where none is active."""
    t = getattr(_local, "timers", None)
    return _NULL if t is None else _Region(t, name)


def count(name: str, n=1):
    """Add `n` (an int or a 0-d tensor) to counter `name` of the `Timers`
    active on this thread."""
    t = getattr(_local, "timers", None)
    if t is not None:
        t.count(name, n)


class Timers:
    """The regions and counters of one model run.

    host_ns[path]: host nanoseconds of each region; counts[path]: its
    entries; `counters`: what `count` added by name (reading it waits for
    the device counts added); `totals`: seconds by path, an outermost
    region's including its device work on a CUDA device (see the module's
    docstring)."""

    # device counts kept apart before they are summed on the device
    FOLD = 256

    def __init__(self, device=None):
        self.host_ns = collections.defaultdict(int)
        self.counts = collections.defaultdict(int)
        self._counters = collections.defaultdict(int)
        self._device_counts = collections.defaultdict(list)
        self._cuda = (device is not None
                      and torch.device(device).type == "cuda")
        self._device_s = collections.defaultdict(float)
        self._pending = collections.deque()   # (path, host s, start, end)
        self._free = []                       # events to record again
        self._path = []
        self._start = time.perf_counter()

    def __call__(self, name: str):
        return _Region(self, name)

    def count(self, name: str, n=1):
        if isinstance(n, torch.Tensor):
            pending = self._device_counts[name]
            pending.append(n)
            if len(pending) >= self.FOLD:
                pending[:] = [torch.stack(pending).sum()]
        else:
            self._counters[name] += n

    @property
    def counters(self) -> dict:
        """The counters by name (reads the device counts added)."""
        for name, pending in self._device_counts.items():
            if pending:
                self._counters[name] += int(torch.stack(pending).sum())
                pending.clear()
        return dict(self._counters)

    def _event(self):
        ev = self._free.pop() if self._free else self._new_event()
        ev.record()
        return ev

    @staticmethod
    def _new_event():
        return torch.cuda.Event(enable_timing=True)

    def _resolve(self, wait: bool):
        pending = self._pending
        while pending:
            path, host_s, start, end = pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                break
            self._device_s[path] += max(host_s,
                                        1e-3 * start.elapsed_time(end))
            self._free += (start, end)
            pending.popleft()

    @property
    def totals(self) -> dict:
        """Seconds by region path (waits for the device's pending work
        on a CUDA device)."""
        self._resolve(wait=True)
        out = collections.defaultdict(float)
        for path, ns in self.host_ns.items():
            out[path] = self._device_s.get(path, 1e-9 * ns)
        return out

    def report(self) -> str:
        totals = self.totals
        total = time.perf_counter() - self._start
        lines = ["Timing information:", f"  {'Total':28s} {total:12.3f} s"]
        children = collections.defaultdict(list)
        for path in totals:
            children[path.rpartition("/")[0]].append(path)

        def walk(parent, depth):
            for path in sorted(children[parent], key=lambda p: -totals[p]):
                name = "  " * depth + path
                lines.append(f"  {name:28s} {totals[path]:12.3f} s   "
                             f"({self.counts[path]}x)")
                walk(path, depth + 1)
        walk("", 0)
        counters = self.counters
        if counters:
            lines.append("Counters:")
            for name, n in sorted(counters.items()):
                lines.append(f"  {name:28s} {n:12d}")
        return "\n".join(lines)


class _Region:
    __slots__ = ("_t", "_name", "_path", "_t0", "_ev0", "_prev", "_rf")

    def __init__(self, timers: Timers, name: str):
        self._t = timers
        self._name = name

    def __enter__(self):
        t = self._t
        stack = t._path
        outer = not stack
        self._path = path = (f"{stack[-1]}/{self._name}" if stack
                             else self._name)
        stack.append(path)
        if outer:
            self._prev = getattr(_local, "timers", None)
            _local.timers = t
        self._t0 = time.perf_counter_ns()
        self._ev0 = t._event() if outer and t._cuda else None
        if _profiling():
            self._rf = torch.profiler.record_function(path)
            self._rf.__enter__()
        else:
            self._rf = None
        return self

    def __exit__(self, *exc):
        t = self._t
        if self._rf is not None:
            self._rf.__exit__(*exc)
        path = self._path
        if self._ev0 is not None:
            end = t._event()
            host_ns = time.perf_counter_ns() - self._t0
            t._pending.append((path, 1e-9 * host_ns, self._ev0, end))
            t._resolve(wait=False)
        else:
            host_ns = time.perf_counter_ns() - self._t0
        t.host_ns[path] += host_ns
        t.counts[path] += 1
        t._path.pop()
        if not t._path:
            _local.timers = self._prev
        return False
