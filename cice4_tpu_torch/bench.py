"""Benchmark: full-model throughput on one GPU.

    BENCH_CONFIG=gx1 python -m cice4_tpu_torch bench

Port of the JAX package's ``bench.py`` (``python -m cice4_tpu bench``):
one model step under a fixed analytic forcing, one warm-up step, then
`NSTEPS` timed steps.  Prints ONE JSON line on stdout, with the JAX
bench's keys and metric text: {"metric": ..., "value": N, "unit": ...,
"vs_baseline": N}.  ``BENCH_CONFIG`` picks the configuration as the JAX
bench does: ``gx1`` (the default), ``access025`` (ACCESS-OM 0.25 degree,
1440x1080 tripole) or anything else for gx3, whose grid files must exist.
Without the gx1 land-mask file the bench runs gx1 on its all-ocean
lat-lon grid (``grid.kmt_file=""``) and says so on stderr.

The clock is the host's wall clock (``time.perf_counter``) over the
timed steps, with ``torch.cuda.synchronize()`` before the first and
after the last, as the JAX bench times ``jax.block_until_ready``.  The
host syncs inside a step (the ridging loop's exit test, the remap's, the
guards) are part of the step and inside the window.  Diagnostics on
stderr, each line starting with ``#``: the card's name and power limit,
the seconds of the warm-up step (the kernel builds included), the timed
steps' regions (:class:`~cice4_tpu_torch.timers.Timers`, each step a
"Step" region: its time to the device finishing the step on a card, the
host time of the spans inside it) and counters, and the launches of the
four default-route kernels in the window (their wrappers' counters).
For end-to-end numbers of the port as its users run it, see
``benchmark/``.

Baseline: the reference CICE 4.1 gx3 log (`ice.log.Linux.LANL.coyote:
782`) — 100x116 x 744 steps / 60.75 s on 4 MPI ranks = 1.42e5
cell-steps/s aggregate, i.e. 3.55e4 cell-steps/s per rank (serial
baseline).  `vs_baseline` is the per-chip speedup over the serial
Fortran rank.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

SERIAL_BASELINE = 1.42e5 / 4.0  # cell-steps/s per reference rank
NSTEPS = 48
# the kernels of the default route, by the name of their source
KERNELS = ("therm_newton", "evp_subcycle", "remap_gsh", "remap_k12")


def _stderr(line):
    print(line, file=sys.stderr, flush=True)


@dataclasses.dataclass
class BenchResult:
    line: str             # the one JSON line of stdout
    value: float          # cell-steps/s
    wall: float           # seconds of the timed steps, host wall clock
    state: object         # the state after the timed steps
    launches: dict        # {kernel: launches in the timed steps}


def bench_config(which: str, log=_stderr):
    """The configuration of ``BENCH_CONFIG=which``."""
    from cice4_tpu_torch.config import access_om_config, gx1_config, \
        gx3_config

    if which == "access025":
        # ACCESS-OM 0.25-degree production scale (1440x1080 tripole,
        # ``bld/config.nci.access-om.1440x1080:8-15``)
        return access_om_config(1440, 1080)
    if which != "gx1":
        return gx3_config()
    cfg = gx1_config()
    if not Path(cfg.grid.kmt_file).exists():
        log(f"# gx1 land mask {cfg.grid.kmt_file} not found: running "
            f"grid.kmt_file='' (the all-ocean lat-lon grid)")
        cfg = cfg.with_values(**{"grid.kmt_file": ""})
    return cfg


def _launch_counts():
    from cice4_tpu_torch.ops import evp_cuda, remap_cuda
    from cice4_tpu_torch.ops import therm_vertical as tv

    wrappers = (tv.temperature_changes, evp_cuda.evp_subcycle,
                remap_cuda.ga_gsh, remap_cuda.k12_divergence)
    return {k: fn.launches for k, fn in zip(KERNELS, wrappers)}


def _card_line() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi not read ({type(exc).__name__})"


def run_bench(cfg, which: str, *, device="cuda", dtype=torch.float32,
              nsteps: int = NSTEPS, log=_stderr) -> BenchResult:
    """Warm-up step and `nsteps` timed steps of the configuration `cfg`
    under ``AnalyticForcing(1.0, 0.0)`` held fixed, step k at yday
    1 + k/24 and sec (k mod 24) * 3600.  The card's line is read only on
    a CUDA device."""
    from cice4_tpu_torch.io.forcing_data import AnalyticForcing
    from cice4_tpu_torch.model import Model
    from cice4_tpu_torch.state import init_state
    from cice4_tpu_torch.timers import Timers

    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        log(f"# card: {torch.cuda.get_device_name(device)}; nvidia-smi "
            f"name, power limit: {_card_line()}")
    model = Model.create(cfg, device=device, dtype=dtype)
    grid = model.grid
    state = init_state(cfg, grid, model.itd, device=device, dtype=dtype)
    forcing = AnalyticForcing(cfg, grid, device=device, dtype=dtype)(1.0, 0.0)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    # warm-up: the first step builds (or loads) the kernels
    sync()
    t0 = time.perf_counter()
    state, _ = model(state, forcing, 1.0, 0.0)
    sync()
    log(f"# first step (kernel builds included): "
        f"{time.perf_counter() - t0:.1f} s")

    timers = Timers(device)
    before = _launch_counts()
    sync()
    t0 = time.perf_counter()
    for k in range(nsteps):
        with timers("Step"):
            state, _ = model(state, forcing, 1.0 + k / 24.0,
                             (k % 24) * 3600.0)
    sync()
    wall = time.perf_counter() - t0
    launches = {k: n - before[k] for k, n in _launch_counts().items()}

    cells = grid.nx * grid.ny
    rate = cells * nsteps / wall
    log(f"# {nsteps} steps in {wall:.3f} s on {device.type} (host wall "
        f"clock, time.perf_counter, synchronised before the first step and "
        f"after the last)")
    totals = timers.totals
    log("# regions a timed step, ms (Step to the device's end, the spans "
        "inside it host time): " + ", ".join(
            f"{path} {1e3 * s / nsteps:.3f}" for path, s in totals.items()))
    log("# counters in the timed steps: " + (", ".join(
        f"{k} {n}" for k, n in timers.counters.items()) or "none"))
    log("# launches in the timed steps: " + ", ".join(
        f"{k} {n}" for k, n in launches.items()))
    line = json.dumps({
        "metric": f"{which} full-model cell-steps/s (1 chip)",
        "value": rate,
        "unit": "cell-steps/s",
        "vs_baseline": rate / SERIAL_BASELINE,
    })
    return BenchResult(line=line, value=rate, wall=wall, state=state,
                       launches=launches)


def main() -> int:
    """``python -m cice4_tpu_torch bench``: the configuration of
    ``BENCH_CONFIG`` in f32 on the card (the caller checks that there is
    one)."""
    which = os.environ.get("BENCH_CONFIG", "gx1")
    res = run_bench(bench_config(which), which)
    print(res.line, flush=True)
    return 0
