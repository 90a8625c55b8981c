"""Replay a test run's durations through pytest-xdist's ``--dist load``
scheduling, to see which worker sets the wall time.

    python -m pytest tests/ ... --junitxml=run.xml          # a run
    python -m pytest tests/ -q -m 'not slow' --collect-only -p no:randomly \
        | grep '::' > order.txt                             # its order
    python tools/replay_xdist_load.py run.xml order.txt [--workers 6]
        [--extra N] [--chunk-of WORKER]

Follows ``xdist.scheduler.load.LoadScheduling``: each worker first takes
a chunk of ``len(collection) // workers // 4`` consecutive tests, then,
below its minimum of pending tests (unless it runs long tests and still
holds two), a batch up to ``len(pending) // workers // 2``; there is no
stealing.  Prints the replayed wall time (from ``--startup`` seconds),
each worker's end, and the tests over 20 s of the worker that ends last.
``--extra N`` appends N instant tests (how the test count moves the
chunks); ``--chunk-of W`` prints the ids of worker W's first chunk.
"""

from __future__ import annotations

import argparse
import heapq
import xml.etree.ElementTree as ET


def durations(junit: str) -> dict[str, float]:
    out = {}
    for case in ET.parse(junit).iter("testcase"):
        path = case.get("classname").replace(".", "/") + ".py"
        out[f"{path}::{case.get('name')}"] = float(case.get("time"))
    return out


def replay(order, dur, workers, startup):
    """(the end of each worker, each worker's (start, seconds, test))."""
    pending = list(range(len(order)))
    queue = {w: [] for w in range(workers)}
    chunk = max(len(order) // workers // 4, 2)
    for w in range(workers):
        queue[w] += pending[:chunk]
        del pending[:chunk]
    ran = {w: [] for w in range(workers)}
    events = [(startup, w) for w in range(workers)]
    heapq.heapify(events)
    end = {}
    while events:
        now, w = heapq.heappop(events)
        if not queue[w]:
            end[w] = now
            continue
        i = queue[w].pop(0)
        d = dur.get(order[i], 0.0)
        ran[w].append((now, d, order[i]))
        now += d
        if pending:
            low = max(2, len(pending) // workers // 4)
            high = max(2, len(pending) // workers // 2)
            if len(queue[w]) < low and not (d >= 0.1 and len(queue[w]) >= 2):
                n = high - len(queue[w])
                queue[w] += pending[:n]
                del pending[:n]
        heapq.heappush(events, (now, w))
    return end, ran


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("junit")
    ap.add_argument("order")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--startup", type=float, default=30.0)
    ap.add_argument("--extra", type=int, default=0)
    ap.add_argument("--chunk-of", type=int)
    args = ap.parse_args()
    dur = durations(args.junit)
    order = [ln.strip() for ln in open(args.order) if "::" in ln]
    order += [f"extra::t{i}" for i in range(args.extra)]
    end, ran = replay(order, dur, args.workers, args.startup)
    last = max(end, key=end.get)
    print(f"{len(order)} tests, {sum(dur.get(t, 0.0) for t in order):.0f} "
          f"test-seconds; replayed wall {end[last]:.0f} s; worker ends "
          + ", ".join(f"{w}: {t:.0f}" for w, t in sorted(end.items())))
    for start, d, test in ran[last]:
        if d > 20.0:
            print(f"  worker {last} at {start:.0f} s: {d:.0f} s {test}")
    if args.chunk_of is not None:
        chunk = max(len(order) // args.workers // 4, 2)
        print("\n".join(order[args.chunk_of * chunk:
                              (args.chunk_of + 1) * chunk]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
