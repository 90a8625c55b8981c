"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the thermodynamics-only gx1 step
(``gx1_config()`` on the spherical lat-lon grid without a land-mask
file, ``dynamics.kdyn=0``, ``transport.advection="none"``, float32,
320x384, 5 categories, 4 ice + 1 snow layers), and checks its one
hand-written kernel, the Newton temperature solve
(``cice4_tpu_torch/csrc/therm_newton.cu``).  Phases, each of which ends
the run with a non-zero exit on failure:

1. device: a CUDA device must be present (there is no CPU fallback);
2. build: compile the kernel from the sources in the checkout;
3. kernel vs plain version on the card, f32 and f64, at (5, 384, 320)
   and (5, 116, 100), with the tolerances of ``kernel_check``;
4. main path: 24 one-hour steps (one model day) with the analytic
   forcing advanced each step; the kernel must launch once per step; no
   conservation guard may fire; the state must be finite, 0 <= aice <= 1,
   with ice north of 70N and south of 60S; and a 24x32 f64 cut of the
   same step on the card must agree with the CPU path (which the tier-1
   tests hold against the JAX package) after 3 steps;
5. timing: ms/step and cell-steps/s of the main path, and the kernel
   against the plain version at the inputs the main path gives it.

The last three lines of standard output are the kernels' JSON record,
the card's name and power limit, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

SOURCE = "cice4_tpu_torch/csrc/therm_newton.cu"
REPLACES = "cice4_tpu/ops/therm_vertical.py:632"
NSTEPS = 24
DT = 3600.0
YDAY0 = 80.0
SLICE = {"grid.kmt_file": "", "dynamics.kdyn": 0,
         "transport.advection": "none"}
SMALL = {"domain.ny_global": 24, "domain.nx_global": 32}
STEP_RTOL = 1.0e-9   # GPU f64 step vs CPU f64 step, relative to field max


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return res.stdout.strip().splitlines()[0]


def slice_config(**over):
    from cice4_tpu_torch.config import gx1_config
    return gx1_config().with_values(**{**SLICE, **over})


def make_run(cfg, device, dtype):
    """(model, state, forcing) of the thermo-only slice."""
    from cice4_tpu_torch.io.forcing_data import AnalyticForcing
    from cice4_tpu_torch.model import Model
    from cice4_tpu_torch.state import init_state

    model = Model.create(cfg, device=device, dtype=dtype)
    state = init_state(cfg, model.grid, model.itd, device=device,
                       dtype=dtype)
    return model, state, AnalyticForcing(cfg, model.grid, device=device,
                                         dtype=dtype)


def run_steps(model, state, forcing, nsteps, first=0, check=True):
    """Advance `nsteps` steps; return (state, per-step ridge iterations,
    last fluxes)."""
    from cice4_tpu_torch.guards import raise_on_violation

    ridge = []
    fluxes = None
    for n in range(first, first + nsteps):
        yday = YDAY0 + n * DT / 86400.0
        state, fluxes = model(state, forcing(yday, 0.0), yday, 0.0)
        ridge.append(fluxes["_ridge_niter"])
        if check:
            raise_on_violation(fluxes["_guards"])
    return state, ridge, fluxes


def state_tensors(state):
    from cice4_tpu_torch.state import STATE_FIELDS
    for k in STATE_FIELDS:
        v = getattr(state, k)
        for name, t in (v.items() if isinstance(v, dict) else [(k, v)]):
            yield name, t


def check_physical(model, state):
    for name, t in state_tensors(state):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"state field {name} is not finite")
    aice = state.aicen.sum(0)
    amin, amax = float(aice.min()), float(aice.max())
    # the area normalisation of cleanup leaves sums within roundoff of 1
    if amin < 0.0 or amax > 1.0 + 4 * torch.finfo(aice.dtype).eps:
        raise AssertionError(f"aice outside [0, 1]: [{amin}, {amax}]")
    lat = torch.rad2deg(model.grid.tlat)
    n_north = int((aice[lat > 70.0] > 0).sum())
    n_south = int((aice[lat < -60.0] > 0).sum())
    if n_north == 0 or n_south == 0:
        raise AssertionError(f"ice cells north of 70N: {n_north}, south "
                             f"of 60S: {n_south}")
    return amin, amax, n_north, n_south


def phase_kernel_check(p, device):
    from cice4_tpu_torch import kernel_check
    from cice4_tpu_torch.ops import therm_vertical as tv

    for shape in ((5, 384, 320), (5, 116, 100)):
        for dtype in (torch.float32, torch.float64):
            args = kernel_check.make_inputs(p, *shape, seed=11,
                                            device=device, dtype=dtype)
            kern = tv.temperature_changes(p, DT, *args)
            plain = tv._temperature_changes_core(p, DT, *args)
            torch.cuda.synchronize()
            rep = kernel_check.compare(kern, plain, args[0], dtype)
            log(f"  {shape} {str(dtype)[6:]}: ok={rep['ok']} icy cells "
                f"{rep['n_ice']}, cells whose convergence or iteration "
                f"count differs {rep['n_flip']}, max niter kernel "
                f"{rep['niter_kernel']} plain {rep['niter_plain']}")
            for k, v in rep["fields"].items():
                log(f"    {k:10s} max|d| {v['max_abs']:.3e} (agreeing cells "
                    f"{v['max_abs_same']:.3e}) max rel {v['max_rel']:.3e} "
                    f"beyond tol {v['n_bad']}")
            if not rep["ok"]:
                raise AssertionError(f"kernel disagrees with plain version "
                                     f"at {shape} {dtype}")


def phase_small_parity(device):
    """The slice at 24x32 in f64: the card (kernel) against the CPU
    (plain version), 3 steps."""
    cfg = slice_config(**SMALL)
    out = []
    for dev in (device, torch.device("cpu")):
        model, state, forcing = make_run(cfg, dev, torch.float64)
        state, _, _ = run_steps(model, state, forcing, 3)
        out.append(dict(state_tensors(state)))
    worst = 0.0
    for name, g in out[0].items():
        c = out[1][name]
        if not g.is_floating_point():
            if not torch.equal(g.cpu(), c):
                raise AssertionError(f"{name} differs between GPU and CPU")
            continue
        scale = max(float(c.abs().max()), 1e-300)
        err = float((g.cpu() - c).abs().max()) / scale
        worst = max(worst, err)
        if err > STEP_RTOL:
            raise AssertionError(f"{name}: GPU vs CPU step differs by {err:.3e}"
                                 f" of its scale (limit {STEP_RTOL})")
    return worst


def time_main_path(model, state, forcing, nsteps):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    state, ridge, _ = run_steps(model, state, forcing, nsteps,
                                first=NSTEPS, check=False)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / nsteps
    return start.elapsed_time(end) / nsteps, host_ms, ridge


def capture_kernel_inputs(model, state, forcing):
    """The arguments the main path passes to temperature_changes in one
    step (the step's results are discarded)."""
    from cice4_tpu_torch.ops import therm_vertical as tv

    real = tv.temperature_changes
    seen = []

    def record(*args):
        seen.append(args)
        return real(*args)

    record.launches = 0
    tv.temperature_changes = record
    try:
        yday = YDAY0 + NSTEPS * DT / 86400.0
        model(state, forcing(yday, 0.0), yday, 0.0)
    finally:
        tv.temperature_changes = real
    return seen[0]


def time_kernel(args, reps_kernel=50, reps_plain=3):
    """Kernel and plain-version times at `args`, in the order plain,
    kernel, kernel, plain.  For the kernel, `device` is the device time
    per launch: a sleep kernel keeps the card busy while the host
    enqueues the launches, so the events bracket only device work; `call`
    is the wall time per call including the wrapper's host work.  The
    plain version synchronises with the host every iteration, so only
    its wall time exists."""
    from cice4_tpu_torch.ops import therm_vertical as tv

    def events():
        return (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def wall(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = events()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def device(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = events()
        torch.cuda._sleep(200_000_000)      # ~0.1 s: outlasts the enqueue
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    kern = lambda: tv.temperature_changes(*args)  # noqa: E731
    plain = lambda: tv._temperature_changes_core(*args)  # noqa: E731
    plain1 = wall(plain, reps_plain)
    k1 = (device(kern, reps_kernel), wall(kern, reps_kernel))
    k2 = (device(kern, reps_kernel), wall(kern, reps_kernel))
    plain2 = wall(plain, reps_plain)
    return (k1, k2), (plain1, plain2)


def profile_step(model, state, forcing):
    """Device time by kernel over one step (torch.profiler); returns
    (total device ms, therm_newton device ms, top entries) or None when
    the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    yday = YDAY0 + (NSTEPS + 1) * DT / 86400.0
    f = forcing(yday, 0.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model(state, f, yday, 0.0)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if "CUDA" in str(getattr(e, "device_type", ""))
            and getattr(e, "self_device_time_total", 0) > 0]
    if not rows:
        return None
    total = sum(r[1] for r in rows)
    newton = sum(r[1] for r in rows if "therm_newton" in r[0])
    rows.sort(key=lambda r: -r[1])
    return total, newton, rows[:8], len(rows)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs only "
              "on the GPU", file=sys.stderr)
        return 1
    from cice4_tpu_torch import cuda_build
    from cice4_tpu_torch.ops import therm_vertical as tv

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"[1/5 device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
        f"torch {torch.__version__} CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = cuda_build.load("therm_newton")
    log(f"[2/5 build] therm_newton: built={lib.built} nvcc {lib.seconds:.2f} s"
        f" (load {time.perf_counter() - t0:.2f} s) -> {lib.path.name}")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            log("    " + line.strip())

    cfg = slice_config()
    model, state, forcing = make_run(cfg, device, torch.float32)
    p = model.thermo
    log("[3/5 kernel vs plain on the card]")
    phase_kernel_check(p, device)

    ny, nx = model.grid.ny, model.grid.nx
    log(f"[4/5 main path] gx1 thermo-only {ny}x{nx}, ncat "
        f"{cfg.domain.ncat}, nilyr {cfg.domain.nilyr}, nslyr "
        f"{cfg.domain.nslyr}, f32, {NSTEPS} steps of {DT:.0f} s")
    state0 = state
    tv.temperature_changes.launches = 0
    state, ridge, fluxes = run_steps(model, state, forcing, NSTEPS)
    torch.cuda.synchronize()
    launches = tv.temperature_changes.launches
    log(f"  therm_newton launches: {launches}; ridge iterations per step: "
        f"{ridge}; thermo max niter last step: "
        f"{int(fluxes['_thermo_niter'])}")
    if launches != NSTEPS:
        raise AssertionError(f"therm_newton launched {launches} times in "
                             f"{NSTEPS} steps")
    amin, amax, n_north, n_south = check_physical(model, state)
    a0 = float(state0.aicen.sum(0).sum())
    log(f"  guards clean; state finite; aice in [{amin:.3g}, {amax:.6g}]; "
        f"icy cells north of 70N {n_north}, south of 60S {n_south}; "
        f"sum aice {a0:.6g} -> {float(state.aicen.sum()):.6g}")
    worst = phase_small_parity(device)
    log(f"  24x32 f64 step on the card vs the CPU path after 3 steps: worst "
        f"difference {worst:.3e} of the field's scale (limit {STEP_RTOL})")

    log(f"[5/5 timing] card: {card}")
    ms_ev, ms_host, ridge_t = time_main_path(model, state, forcing, 8)
    log(f"  main path: {ms_ev:.3f} ms/step (CUDA events), {ms_host:.3f} ms/"
        f"step (host clock), {ny * nx / (ms_ev / 1e3):.4g} cell-steps/s; "
        f"ridge iterations {ridge_t}; card: {card}")
    args = capture_kernel_inputs(model, state, forcing)
    kern_ms, plain_ms = time_kernel(args)
    log(f"  therm_newton at the main path's inputs (5x{ny}x{nx} f32): "
        f"kernel device time {kern_ms[0][0]:.4f} / {kern_ms[1][0]:.4f} ms "
        f"per launch, wall {kern_ms[0][1]:.4f} / {kern_ms[1][1]:.4f} ms per "
        f"call with the wrapper; plain version {plain_ms[0]:.3f} / "
        f"{plain_ms[1]:.3f} ms (order plain, kernel, kernel, plain); card: "
        f"{card}")
    kern = tv.temperature_changes(*args)
    plain = tv._temperature_changes_core(*args)
    torch.cuda.synchronize()
    max_abs_err = max(float((kern[k] - plain[k]).abs().max())
                      for k in ("Tsf", "Tsn", "Tin"))
    flips = int(((kern["converged"] != plain["converged"])
                 | (kern["niter_cells"] != plain["niter_cells"])).sum())
    log(f"  at those inputs: max |kernel - plain| of the temperatures "
        f"{max_abs_err:.3e} C; cells whose convergence or iteration count "
        f"differs {flips} of {int(args[2].sum())} icy")
    prof = profile_step(model, state, forcing)
    if prof is None:
        log("  profiler: no device time recorded (not measured)")
    else:
        total, newton, top, nkinds = prof
        log(f"  profiler, one step: {total:.3f} ms device time in {nkinds} "
            f"kernel kinds; therm_newton {newton:.3f} ms "
            f"({100 * newton / total:.1f}%)")
        for key, ms, count in top:
            log(f"    {ms:9.3f} ms  x{count:5d}  {key[:90]}")

    record = {"kernels": [{
        "name": "therm_newton", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max_abs_err, "ms": min(k[0] for k in kern_ms),
        "plain_ms": min(plain_ms)}]}
    for v in record["kernels"][0].values():
        if isinstance(v, float) and not math.isfinite(v):
            raise AssertionError(f"non-finite number in {record}")
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
