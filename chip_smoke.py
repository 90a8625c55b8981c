"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the default gx1 step (``gx1_config()`` on
the spherical lat-lon grid without a land-mask file: CCSM3 radiation,
Newton column thermo, ITD, EVP dynamics with 120 subcycles, incremental
remapping, ridging and cleanup, float32, 320x384, 5 categories, 4 ice +
1 snow layers), and the earlier thermodynamics-only path
(``dynamics.kdyn=0``, ``transport.advection="none"``), and checks the
four hand-written kernels of the main path against their plain PyTorch
versions:

* ``therm_newton`` (``csrc/therm_newton.cu``), the Newton temperature
  solve;
* ``evp_subcycle`` (``csrc/evp_subcycle.cu``), the EVP subcycle loop;
* ``remap_gsh`` (``csrc/remap_gsh.cu``), the remap geometry (GSH);
* ``remap_k12`` (``csrc/remap_k12.cu``), the remap reconstruction and
  contraction.

Phases, each of which ends the run with a non-zero exit on failure:

1. device: a CUDA device must be present (there is no CPU fallback);
2. build: compile the four kernels from the sources in the checkout, one
   nvcc each, all started together;
3. kernels vs plain versions on the card, f32 and f64, with the
   tolerances of ``kernel_check``: therm_newton at (5, 384, 320) and
   (5, 116, 100); the dynamics kernels at 384x320 and 116x100 with
   ice-free bands, EW cyclic and closed, NS closed and open;
4. main path: 24 one-hour steps (one model day) with the analytic
   forcing; each of the four kernels must launch once per step; no
   conservation guard may fire; the state must be finite, 0 <= aice <= 1,
   with ice north of 70N and south of 60S and 0 < max|u| < 2 m/s;
5. earlier path: 4 thermodynamics-only steps, therm_newton once per step
   and no dynamics kernel;
6. small parity: a 24x32 f64 cut of the main path on the card must agree
   with the CPU path (which the tier-1 tests hold against the JAX
   package) after 3 steps;
7. timing: ms/step and cell-steps/s of the main path, device time by
   phase, and each kernel against its plain version at the inputs the
   main path gives it, beside the least time the card could take.

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

NSTEPS = 24
THERMO_STEPS = 4
DT = 3600.0
YDAY0 = 80.0
MAIN = {"grid.kmt_file": ""}
THERMO_ONLY = {"grid.kmt_file": "", "dynamics.kdyn": 0,
               "transport.advection": "none"}
SMALL = {"domain.ny_global": 24, "domain.nx_global": 32}
STEP_RTOL = 1.0e-9   # GPU f64 step vs CPU f64 step, relative to field max
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W; the
# f32 and f64 rates outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}

KERNELS = {
    "therm_newton": ("cice4_tpu_torch/csrc/therm_newton.cu",
                     "cice4_tpu/ops/therm_vertical.py:632"),
    "evp_subcycle": ("cice4_tpu_torch/csrc/evp_subcycle.cu",
                     "cice4_tpu/ops/evp_pallas.py:210"),
    "remap_gsh": ("cice4_tpu_torch/csrc/remap_gsh.cu",
                  "cice4_tpu/ops/remap_pallas.py:70"),
    "remap_k12": ("cice4_tpu_torch/csrc/remap_k12.cu",
                  "cice4_tpu/ops/remap_pallas.py:157"),
}

# Operations each kernel's function does, counted from the CUDA sources
# (one per add, multiply, compare, min/max, division or square root):
# Newton solve: an upper estimate per iteration of an icy cell;
# EVP: per active T cell and subcycle (strain rates 84, relaxation 85,
# str8 188), per active U point (momentum 43), the final pass over all
# cells adds the 4 corner sums; GSH: per cell, both edges' geometry,
# areas, quadrature and moment sums plus the gather, by quadrature order;
# K12: per (row, cell) the reconstruction of the mass (100), of each
# type-1 (111) and type-2 (113) tracer, and per donor offset the mass
# (6), type-1 (24) and type-2 (73) contraction terms.
OPS_NEWTON_ITER = 300
OPS_EVP_STRESS, OPS_EVP_MOMENTUM, OPS_EVP_FINAL_SUMS = 357, 43, 12
OPS_GSH_CELL = {1: 1204, 2: 1948, 3: 2248}
OPS_K12_MASS, OPS_K12_T1, OPS_K12_T2 = 100, 111, 113
OPS_K12_OFF_MASS, OPS_K12_OFF_T1, OPS_K12_OFF_T2 = 6, 24, 73


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return res.stdout.strip().splitlines()[0]


def make_config(over, **more):
    from cice4_tpu_torch.config import gx1_config
    return gx1_config().with_values(**{**over, **more})


def make_run(cfg, device, dtype):
    """(model, state, forcing) of a configuration."""
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


def check_physical(model, state, moving):
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
    umax = float(torch.maximum(state.uvel.abs(), state.vvel.abs()).max())
    if moving and not 0.0 < umax < 2.0:
        raise AssertionError(f"max |u|, |v| = {umax} m/s outside (0, 2)")
    return amin, amax, n_north, n_south, umax


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------


def wrappers():
    """{kernel name: (module, name of its wrapper there, plain version)}.
    Each wrapper holds its launch count in `.launches`."""
    from cice4_tpu_torch.ops import evp as evp_ops
    from cice4_tpu_torch.ops import evp_cuda, remap_cuda
    from cice4_tpu_torch.ops import therm_vertical as tv
    return {"therm_newton": (tv, "temperature_changes",
                             tv._temperature_changes_core),
            "evp_subcycle": (evp_cuda, "evp_subcycle",
                             evp_ops._evp_subcycle_plain),
            "remap_gsh": (remap_cuda, "ga_gsh", remap_cuda.ga_gsh_plain),
            "remap_k12": (remap_cuda, "k12_divergence",
                          remap_cuda.k12_plain)}


def reset_counts():
    for mod, attr, _ in wrappers().values():
        getattr(mod, attr).launches = 0


def read_counts():
    return {k: getattr(mod, attr).launches
            for k, (mod, attr, _) in wrappers().items()}


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_newton(p, device):
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
            log(f"  therm_newton {shape} {str(dtype)[6:]}: ok={rep['ok']} "
                f"icy cells {rep['n_ice']}, cells whose convergence or "
                f"iteration count differs {rep['n_flip']}, max niter kernel "
                f"{rep['niter_kernel']} plain {rep['niter_plain']}")
            for k, v in rep["fields"].items():
                log(f"    {k:10s} max|d| {v['max_abs']:.3e} (agreeing cells "
                    f"{v['max_abs_same']:.3e}) max rel {v['max_rel']:.3e} "
                    f"beyond tol {v['n_bad']}")
            if not rep["ok"]:
                raise AssertionError(f"therm_newton disagrees with its plain "
                                     f"version at {shape} {dtype}")


def _log_fields(rep):
    """Per output: max |kernel - plain|, the same relative to the field's
    scale, elements beyond the tolerance (four outputs to a line)."""
    items = [f"{k} {v['max_abs']:.2e}/{v['max_rel']:.2e}/{v['n_bad']}"
             + ("" if v["finite"] else " NOT FINITE")
             for k, v in rep.items()]
    for i in range(0, len(items), 4):
        log("    max|d|/rel/beyond tol: " + "; ".join(items[i:i + 4]))


def check_dynamics_kernels(device):
    """evp_subcycle, remap_gsh and remap_k12 against their plain versions,
    f32 and f64, gx1 and a ragged shape, EW cyclic and closed, NS closed
    and open."""
    from cice4_tpu_torch import kernel_check as kc
    from cice4_tpu_torch.config import DynamicsConfig
    from cice4_tpu_torch.grid import make_grid
    from cice4_tpu_torch.ops import evp as evp_ops
    from cice4_tpu_torch.ops import evp_cuda, remap_cuda
    from cice4_tpu_torch.ops.remap import _tracer_meta

    meta = _tracer_meta(["iage"], 4, 1)
    p = evp_ops.make_evp_params(DynamicsConfig(), DT)
    for (ny, nx) in ((384, 320), (116, 100)):
        for ew, ns in (("cyclic", "closed"), ("closed", "open")):
            for dtype in (torch.float32, torch.float64):
                cfg = make_config(MAIN, **{
                    "domain.ny_global": ny, "domain.nx_global": nx,
                    "domain.ew_boundary_type": ew,
                    "domain.ns_boundary_type": ns})
                grid = make_grid(cfg, device=device, dtype=dtype)
                tag = f"{ny}x{nx} EW {ew} NS {ns} {str(dtype)[6:]}"

                args = kc.evp_inputs(grid, seed=3, dtype=dtype)
                kern = kc.evp_named(evp_cuda.evp_subcycle(p, grid, *args))
                plain = kc.evp_named(evp_ops._evp_subcycle_plain(p, grid,
                                                                 *args))
                torch.cuda.synchronize()
                rep = kc.compare_fields(kern, plain, kc.EVP_RTOL[dtype])
                ok = kc.fields_ok(rep)
                log(f"  evp_subcycle {tag}: ok={ok}, icy T cells "
                    f"{int(args[1].sum())}, U points {int(args[2].sum())}")
                _log_fields(rep)
                if not ok:
                    raise AssertionError(f"evp_subcycle disagrees at {tag}")

                dx, dy, afac, mm, tm = kc.remap_inputs(grid, seed=5, ncat=5,
                                                       meta=meta, dtype=dtype)
                gsh, codes = remap_cuda.edge_cases_cuda(dx, dy, afac,
                                                        grid.bc, 2)
                gsh_p = remap_cuda.ga_gsh_plain(dx, dy, afac, grid.bc, 2)
                codes_p = remap_cuda.edge_cases_plain(dx, dy, afac, grid.bc)
                torch.cuda.synchronize()
                flips = int((codes != codes_p).sum())
                rep = kc.compare_fields({"gsh": gsh}, {"gsh": gsh_p},
                                        kc.GSH_RTOL[dtype])
                ok = (flips <= kc.GSH_MAX_FLIP_SHARE[dtype] * codes.numel()
                      and kc.fields_ok(rep, allowed_bad=90 * 25 * flips))
                log(f"  remap_gsh {tag}: ok={ok}, edges {codes.numel()}, "
                    f"edges whose case differs {flips}, distinct cases "
                    f"{len(set(codes_p.flatten().tolist()))}")
                _log_fields(rep)
                if not ok:
                    raise AssertionError(f"remap_gsh disagrees at {tag}")

                div, divt = remap_cuda.k12_divergence(gsh_p, grid.hm, mm, tm,
                                                      meta, grid.bc)
                div_p, divt_p = remap_cuda.k12_plain(gsh_p, grid.hm, mm, tm,
                                                     meta, grid.bc)
                torch.cuda.synchronize()
                rep = kc.compare_fields({"div": div, "divt": divt},
                                        {"div": div_p, "divt": divt_p},
                                        kc.K12_RTOL[dtype])
                ok = kc.fields_ok(rep)
                log(f"  remap_k12 {tag}: ok={ok}, rows {mm.shape[0]}, "
                    f"tracers {len(meta)}")
                _log_fields(rep)
                if not ok:
                    raise AssertionError(f"remap_k12 disagrees at {tag}")


# ---------------------------------------------------------------------------
# phases 4-6: the paths
# ---------------------------------------------------------------------------


def drive_path(name, cfg, device, nsteps, expect, moving):
    """Counts to 0, `nsteps` steps, counts read; `expect` maps each kernel
    to its launches.  Returns (model, state, forcing, ridge, fluxes)."""
    model, state, forcing = make_run(cfg, device, torch.float32)
    a0 = float(state.aicen.sum())
    reset_counts()
    state, ridge, fluxes = run_steps(model, state, forcing, nsteps)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"  {name}: launches {counts}; ridge iterations per step {ridge}")
    if counts != expect:
        raise AssertionError(f"{name}: launches {counts}, expected {expect}")
    amin, amax, n_north, n_south, umax = check_physical(model, state,
                                                        moving)
    log(f"  guards clean; state finite; aice in [{amin:.3g}, {amax:.6g}]; "
        f"icy cells north of 70N {n_north}, south of 60S {n_south}; max "
        f"|u|,|v| {umax:.4g} m/s; sum aice {a0:.6g} -> "
        f"{float(state.aicen.sum()):.6g}; thermo max niter last step "
        f"{int(fluxes['_thermo_niter'])}")
    return model, state, forcing, ridge, fluxes


def phase_small_parity(device):
    """The main path at 24x32 in f64: the card (kernels) against the CPU
    (plain versions), 3 steps."""
    cfg = make_config(MAIN, **SMALL)
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


# ---------------------------------------------------------------------------
# phase 7: timing
# ---------------------------------------------------------------------------


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
    """The arguments the main path passes to each kernel wrapper in one
    step (the step's results are discarded)."""
    sites = wrappers()
    real = {k: getattr(mod, attr) for k, (mod, attr, _) in sites.items()}
    seen = {}

    def recorder(name):
        def record(*args):
            seen.setdefault(name, args)
            return real[name](*args)
        record.launches = 0
        return record

    for k, (mod, attr, _) in sites.items():
        setattr(mod, attr, recorder(k))
    try:
        yday = YDAY0 + NSTEPS * DT / 86400.0
        model(state, forcing(yday, 0.0), yday, 0.0)
    finally:
        for k, (mod, attr, _) in sites.items():
            setattr(mod, attr, real[k])
    return seen


def kernel_and_plain(name, args):
    """(kernel call, plain call) on the captured arguments."""
    mod, attr, plain = wrappers()[name]
    kern = getattr(mod, attr)
    return (lambda: kern(*args)), (lambda: plain(*args))


def time_pair(kern, plain, reps_kernel=50, reps_plain=3):
    """Kernel and plain-version times, in the order plain, kernel, kernel,
    plain.  For the kernel, `device` is the device time per launch: a
    sleep kernel keeps the card busy while the host enqueues the launches,
    so the events bracket only device work; `call` is the wall time per
    call including the wrapper's host work.  The plain versions
    synchronise with the host or are host-bound, so only their wall time
    is meaningful."""
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

    plain1 = wall(plain, reps_plain)
    k1 = (device(kern, reps_kernel), wall(kern, reps_kernel))
    k2 = (device(kern, reps_kernel), wall(kern, reps_kernel))
    plain2 = wall(plain, reps_plain)
    return (k1, k2), (plain1, plain2)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)


def unique_bytes(obj):
    """Bytes of the distinct elements of every tensor in `obj`: a
    broadcast (zero-stride) dimension counts once."""
    total = 0
    for t in _tensors(obj):
        n = 1
        for size, stride in zip(t.shape, t.stride()):
            if stride != 0:
                n *= size
        total += n * t.element_size()
    return total


def bound(name, args, out):
    """(bound_ms, bound_by, bytes, operations) of one call: the bytes its
    function must move (each input read once, each output written once)
    over the card's memory rate, against the operations this call's data
    needs over the card's peak rate for the type."""
    from cice4_tpu_torch.ops.remap import _n_type1

    if name == "therm_newton":
        nbytes = unique_bytes(args[2:]) + unique_bytes(out)
        ops = OPS_NEWTON_ITER * float(out["niter_cells"].sum())
        dtype = args[-1].dtype
    elif name == "evp_subcycle":
        p, grid = args[0], args[1]
        nbytes = unique_bytes(args[2:]) + unique_bytes(
            [getattr(grid, k) for k in ("cyp", "cxp", "cym", "cxm", "dxt",
                                        "dyt", "dxhy", "dyhx", "tinyarea",
                                        "uarear")]) + unique_bytes(out)
        n_t, n_u = float(args[3].sum()), float(args[4].sum())
        ncell = grid.ny * grid.nx
        ops = ((p.ndte - 1) * (OPS_EVP_STRESS * n_t + OPS_EVP_MOMENTUM * n_u)
               + (OPS_EVP_STRESS + OPS_EVP_FINAL_SUMS) * ncell
               + OPS_EVP_MOMENTUM * n_u)
        dtype = args[-1].dtype
    elif name == "remap_gsh":
        dx, order = args[0], args[4]
        nbytes = unique_bytes(args[:3]) + unique_bytes(out)
        ops = OPS_GSH_CELL[order] * dx.numel()
        dtype = dx.dtype
    else:
        gsh, hm, mm, tm, meta = args[:5]
        nbytes = unique_bytes(args[:4]) + unique_bytes(out)
        n1 = _n_type1(meta)
        n2 = len(meta) - n1
        ncell = hm.numel()
        row0 = OPS_K12_MASS + 9 * OPS_K12_OFF_MASS
        rows = (OPS_K12_MASS + n1 * OPS_K12_T1 + n2 * OPS_K12_T2
                + 9 * (OPS_K12_OFF_MASS + n1 * OPS_K12_OFF_T1
                       + n2 * OPS_K12_OFF_T2))
        ops = ncell * (row0 + (mm.shape[0] - 1) * rows)
        dtype = hm.dtype
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def max_abs_err(name, kern, plain):
    """Largest |kernel - plain| over the outputs of one call."""
    from cice4_tpu_torch import kernel_check as kc

    if name == "therm_newton":
        return max(float((kern[k] - plain[k]).abs().max())
                   for k in ("Tsf", "Tsn", "Tin"))
    if name == "evp_subcycle":
        kern, plain = kc.evp_named(kern), kc.evp_named(plain)
        return max(float((kern[k] - plain[k]).abs().max()) for k in plain)
    if name == "remap_gsh":
        return float((kern - plain).abs().max())
    return max(float((a - b).abs().max()) for a, b in zip(kern, plain))


def phase_device_times(model, state, forcing):
    """Device time by phase of one main-path step: each phase is profiled
    (torch.profiler, device kernels only) in a step of its own, between
    synchronisations, and the whole step once.  Returns (by phase, step
    total, number of kernel kinds, top kernels) or None when the profiler
    saw no device time."""
    import cice4_tpu_torch.model as M
    from torch.profiler import ProfilerActivity, profile

    from cice4_tpu_torch.ops import itd as itd_ops
    from cice4_tpu_torch.ops import mechred

    def device_rows(prof):
        return [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if "CUDA" in str(getattr(e, "device_type", ""))
                and getattr(e, "self_device_time_total", 0) > 0]

    def profiled(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        return out, device_rows(prof)

    yday = YDAY0 + (NSTEPS + 1) * DT / 86400.0
    f = forcing(yday, 0.0)
    _, rows = profiled(lambda: model(state, f, yday, 0.0))
    if not rows:
        return None
    total = sum(r[1] for r in rows)

    phases = {"radiation": [(M, "_step_radiation")],
              "thermo": [(M, "_step_therm1"), (M, "_step_therm2")],
              "EVP": [(M, "evp")], "remap": [(M, "transport_remap")],
              "ridging": [(mechred, "ridge_ice")],
              "cleanup": [(itd_ops, "cleanup_itd")],
              "coupling": [(M, "_coupling_prep")]}
    by_phase = {}
    for phase, sites in phases.items():
        acc = [0.0]
        in_dynamics = [False]
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr in sites]
        saved.append((M, "_step_dynamics", M._step_dynamics))

        def wrap(orig):
            def run(*a, **k):
                # cleanup: only the dynamics' own call (ITD has another)
                if phase == "cleanup" and not in_dynamics[0]:
                    return orig(*a, **k)
                out, prow = profiled(lambda: orig(*a, **k))
                acc[0] += sum(r[1] for r in prow)
                return out
            return run

        def dyn(*a, _orig=M._step_dynamics, **k):
            in_dynamics[0] = True
            try:
                return _orig(*a, **k)
            finally:
                in_dynamics[0] = False

        try:
            for mod, attr, orig in saved[:-1]:
                setattr(mod, attr, wrap(orig))
            M._step_dynamics = dyn
            model(state, f, yday, 0.0)
            torch.cuda.synchronize()
        finally:
            for mod, attr, orig in saved:
                setattr(mod, attr, orig)
        by_phase[phase] = acc[0]
    rows.sort(key=lambda r: -r[1])
    return by_phase, total, len(rows), rows[:10]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs only "
              "on the GPU", file=sys.stderr)
        return 1
    from cice4_tpu_torch import cuda_build

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"[1/7 device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
        f"torch {torch.__version__} CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    libs = cuda_build.load_all(KERNELS)
    log(f"[2/7 build] {len(libs)} kernels in {time.perf_counter() - t0:.2f} s"
        f" wall, built in parallel")
    for name, lib in libs.items():
        log(f"  {name}: built={lib.built} nvcc {lib.seconds:.2f} s -> "
            f"{lib.path.name}")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line:
                log("    " + line.strip())

    cfg = make_config(MAIN)
    ny, nx = cfg.domain.ny_global, cfg.domain.nx_global
    log("[3/7 kernels vs plain versions on the card]")
    model, _, _ = make_run(cfg, device, torch.float32)
    check_newton(model.thermo, device)
    check_dynamics_kernels(device)

    log(f"[4/7 main path] gx1 default step {ny}x{nx}, ncat "
        f"{cfg.domain.ncat}, nilyr {cfg.domain.nilyr}, nslyr "
        f"{cfg.domain.nslyr}, ndte {cfg.dynamics.ndte}, advection "
        f"{cfg.transport.advection}, f32, {NSTEPS} steps of {DT:.0f} s")
    model, state, forcing, ridge, _ = drive_path(
        "main path", cfg, device, NSTEPS, {k: NSTEPS for k in KERNELS},
        moving=True)
    launches = read_counts()
    log(f"  ridge iterations per step: {ridge} (cap 20; "
        f"{sum(r == 20 for r in ridge)} steps at the cap)")

    log(f"[5/7 earlier path] gx1 thermodynamics only, f32, {THERMO_STEPS} "
        f"steps")
    thermo_run = drive_path(
        "thermo-only path", make_config(THERMO_ONLY), device, THERMO_STEPS,
        {k: (THERMO_STEPS if k == "therm_newton" else 0) for k in KERNELS},
        moving=False)

    log("[6/7 small parity] 24x32 f64 main path, card vs CPU, 3 steps")
    worst = phase_small_parity(device)
    log(f"  worst difference {worst:.3e} of the field's scale (limit "
        f"{STEP_RTOL})")

    log(f"[7/7 timing] card: {card}")
    ms_ev, ms_host, ridge_t = time_main_path(model, state, forcing, 8)
    log(f"  main path: {ms_ev:.3f} ms/step (CUDA events, 8 steps after "
        f"{NSTEPS}), {ms_host:.3f} ms/step (host clock), "
        f"{ny * nx / (ms_ev / 1e3):.4g} cell-steps/s; ridge iterations "
        f"{ridge_t}; card: {card}")
    ms_thermo, _, _ = time_main_path(*thermo_run[:3], 8)
    log(f"  earlier path (thermodynamics only), same card: {ms_thermo:.3f} "
        f"ms/step (CUDA events, 8 steps)")
    prof = phase_device_times(model, state, forcing)
    if prof is None:
        log("  profiler: no device time recorded (not measured)")
    else:
        by_phase, total, nkinds, top = prof
        log(f"  profiler, one step: {total:.3f} ms device time in {nkinds} "
            f"kernel kinds ({100 * total / ms_ev:.1f}% of the step's "
            f"{ms_ev:.3f} ms); by phase:")
        for phase, ms in by_phase.items():
            log(f"    {phase:10s} {ms:9.3f} ms ({100 * ms / total:.1f}%)")
        log(f"    {'other':10s} {total - sum(by_phase.values()):9.3f} ms")
        for key, ms, count in top:
            log(f"    {ms:9.3f} ms  x{count:5d}  {key[:90]}")

    seen = capture_kernel_inputs(model, state, forcing)
    record = {"kernels": []}
    for name, (source, replaces) in KERNELS.items():
        args = seen[name]
        kern_fn, plain_fn = kernel_and_plain(name, args)
        kern, plain = kern_fn(), plain_fn()
        torch.cuda.synchronize()
        err = max_abs_err(name, kern, plain)
        reps_plain = 2 if name == "evp_subcycle" else 3
        kern_ms, plain_ms = time_pair(kern_fn, plain_fn,
                                      reps_plain=reps_plain)
        bound_ms, bound_by, nbytes, ops = bound(name, args, kern)
        ms = min(k[0] for k in kern_ms)
        log(f"  {name} at the main path's inputs: kernel device time "
            f"{kern_ms[0][0]:.4f} / {kern_ms[1][0]:.4f} ms per launch, wall "
            f"{kern_ms[0][1]:.4f} / {kern_ms[1][1]:.4f} ms per call with "
            f"the wrapper; plain version {plain_ms[0]:.3f} / "
            f"{plain_ms[1]:.3f} ms (order plain, kernel, kernel, plain); "
            f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB, "
            f"{ops / 1e9:.4g} G operations), {100 * bound_ms / ms:.1f}% of "
            f"it; max |kernel - plain| {err:.3e}; card: {card}")
        record["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": min(plain_ms),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None})
    for entry in record["kernels"]:
        for v in entry.values():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"non-finite number in {entry}")
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
