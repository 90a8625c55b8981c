"""The ranks of a run: one process a card for a cell that asks for more
than one chip, and the harness's own messages between them.

``launch`` starts the ranks of a cell, each a process of
``harness/rank.py`` on its own card, with the environment the port reads
(``CICE4_DISTRIBUTED``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``), and waits for them; rank 0's standard
output is the run's, the others' goes to standard error.  In a rank,
``Ranks`` creates the default process group (NCCL on the card, gloo on
the CPU), which the port's ``init_distributed`` then finds, and a gloo
side group for the harness's own small messages: the window's decision
after each step, and the snapshots, bands and readings it gathers to
rank 0.  ``SOLO`` is a run of one process, in which every message is the
identity.
"""

from __future__ import annotations

import datetime
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

RANK_SCRIPT = Path(__file__).resolve().parent / "rank.py"
# how long a rank waits for the others in one message
TIMEOUT = datetime.timedelta(seconds=900)


class Solo:
    """One process: rank 0 of 1."""

    rank, size = 0, 1

    def decide(self, code: int) -> int:
        return code

    def gather(self, obj):
        return [obj]

    def scatter(self, objs):
        return objs[0]

    def broadcast(self, obj):
        return obj


SOLO = Solo()


class Ranks:
    """This process's rank of the run, from the launcher's environment;
    joins the default group on `device` and the harness's gloo group."""

    def __init__(self, device):
        import torch.distributed as dist

        self.dist = dist
        self.rank = int(os.environ["RANK"])
        self.size = int(os.environ["WORLD_SIZE"])
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo", init_method="env://",
            rank=self.rank, world_size=self.size, timeout=TIMEOUT)
        self.side = dist.new_group(backend="gloo", timeout=TIMEOUT)
        self._code = torch.zeros(1, dtype=torch.int64)

    def decide(self, code: int) -> int:
        """Rank 0's `code` on every rank, once every rank has called this:
        the window's one wait a step (the others' codes are ignored)."""
        self._code.fill_(code if self.rank == 0 else 0)
        self.dist.all_reduce(self._code, group=self.side)
        return int(self._code.item())

    def gather(self, obj):
        """Every rank's `obj`, in rank order, on rank 0 (None elsewhere)."""
        out = [None] * self.size if self.rank == 0 else None
        self.dist.gather_object(obj, out, dst=0, group=self.side)
        return out

    def scatter(self, objs):
        """Rank 0's `objs[r]` on rank r (`objs` is read on rank 0 only)."""
        out = [None]
        self.dist.scatter_object_list(out, objs if self.rank == 0 else None,
                                      src=0, group=self.side)
        return out[0]

    def broadcast(self, obj):
        """Rank 0's `obj` on every rank."""
        box = [obj]
        self.dist.broadcast_object_list(box, src=0, group=self.side)
        return box[0]

    def close(self):
        if self.dist.is_initialized():
            self.dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(spec: dict, n: int, *, stdout=None, stderr=None) -> int:
    """Run ``cell.run_cell(**spec)`` on `n` ranks, rank r on card r (or on
    the CPU where the spec's device is ``cpu``), and return the first
    failing rank's exit code, or 0.  Rank 0's standard output goes to
    `stdout`, the others' to `stderr`, and every rank's standard error
    to `stderr` (default: this process's).  A rank that fails ends the
    others.  Without a `stdout`, this process prints the result once
    every rank has ended well and it has loaded no forbidden module:
    the checks as the last lines of standard error, after every rank's
    own, and the line as the last of standard output."""
    from harness import cell

    own = stdout is None
    if own:
        stdout = tempfile.TemporaryFile("w+")
    port = free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, CICE4_DISTRIBUTED="1", RANK=str(r),
                   WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, str(RANK_SCRIPT), json.dumps(spec)], env=env,
            stdout=stdout if r == 0 else (2 if stderr is None else stderr),
            stderr=stderr))

    def end(*_a):
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    old = signal.signal(signal.SIGTERM, lambda *a: (end(), sys.exit(143)))
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                print(f"a rank ended with exit code {bad[0]}: ending the "
                      f"others", file=sys.stderr, flush=True)
                rc = bad[0]
                break
            if all(c == 0 for c in codes):
                rc = 0
                break
            time.sleep(0.1)
    finally:
        end()
        signal.signal(signal.SIGTERM, old)
    if not own:
        return rc
    stdout.seek(0)
    lines = stdout.read().splitlines()
    stdout.close()
    if rc != 0 or not lines:
        return rc or 1
    return cell.emit(json.loads(lines[-1]), cell.forbidden_loaded())
