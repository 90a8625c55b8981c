"""One run of one cell: its inputs from the seed, the program's set-up
and warm-up, the measured window, the optional trace, and the comparison
with the plain reference that decides `correct`.

Every piece is found by name: the cell in ``BENCHMARK.json``, its
configuration in ``benchmark/configs/<config>.json``, its traffic in
``benchmark/traffic/<cell>.json`` and each per-layer metric's reader in
``benchmark/metrics/<metric>.py``.  Two entries drive the program:
``driver`` (``IceModelRun``, one ``run(npt=1)`` a step, as ``python -m
cice4_tpu_torch run`` runs it) and ``component`` (``IceComponent``, one
``run(imports, n_steps)`` a coupling interval, then a synchronisation,
as a coupler that passes the exports on must wait for them).
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import importlib.util
import json
import math
import os
import random
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

from harness import check, inputs

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
DTYPES = {"float32": torch.float32, "float64": torch.float64}
# the state's fields, as the port's State names them
STATE_FIELDS = ("aicen", "vicen", "vsnon", "eicen", "esnon", "tsfcn",
                "trcrn", "uvel", "vvel", "stressp", "stressm", "stress12",
                "iceumask", "sst", "frzmlt", "scale_factor", "strocnxT",
                "strocnyT", "swn")


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# the pieces, by name
# ---------------------------------------------------------------------------


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_pieces(name: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(workload entry, configuration file, traffic file) of a cell."""
    m = manifest(root)
    wl = {w["name"]: w for w in m["workloads"]}.get(name)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = {c["name"]: c for c in m["configs"]}[wl["config"]]
    bench = root / "benchmark"
    return (wl, read_json(root / cfg["file"]),
            read_json(bench / "traffic" / f"{wl['traffic']}.json"))


def metric_reader(name: str, root: Path = ROOT):
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def merged_tree(base: dict, *dotted: dict) -> dict:
    """The configuration tree `base` with dotted overrides over it."""
    tree = copy.deepcopy(base)
    for over in dotted:
        for key, val in (over or {}).items():
            sec, field = key.split(".", 1)
            tree.setdefault(sec, {})[field] = val
    return tree


# ---------------------------------------------------------------------------
# state snapshots
# ---------------------------------------------------------------------------


def fields_of(state) -> dict:
    return {k: getattr(state, k) for k in STATE_FIELDS}


def snapshot(obj):
    """A copy of a tensor or nested dict of tensors, detached from what
    the program keeps."""
    if isinstance(obj, dict):
        return {k: snapshot(v) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    return obj


class Faulty:
    """The program's model with a planted fault (for the harness's own
    tests of `correct`): ``unchanged`` returns the state it was given,
    ``half`` leaves the northern half of the grid unstepped, ``alter``
    halves the ice of one cell of the result."""

    def __init__(self, model, kind: str):
        self._model, self._kind = model, kind

    def __getattr__(self, name):
        return getattr(self._model, name)

    def __call__(self, state, *args, **kw):
        new, fluxes = self._model(state, *args, **kw)
        if self._kind == "unchanged":
            return state, fluxes
        if self._kind == "half":
            ny = state.aicen.shape[-2]

            def keep(old, cur):
                if isinstance(old, dict):
                    return {k: keep(old[k], cur[k]) for k in old}
                if not isinstance(old, torch.Tensor) or old.dim() < 2:
                    return cur
                out = cur.clone()
                out[..., ny // 2:, :] = old[..., ny // 2:, :]
                return out
            return new.replace(**{k: keep(getattr(state, k), getattr(new, k))
                                  for k in STATE_FIELDS}), fluxes
        if self._kind == "alter":
            aice = new.aicen.sum(0)
            j, i = divmod(int(torch.argmax(aice)), aice.shape[-1])
            aicen = new.aicen.clone()
            vicen = new.vicen.clone()
            aicen[:, j, i] *= 0.5
            vicen[:, j, i] *= 0.5
            return new.replace(aicen=aicen, vicen=vicen), fluxes
        raise ValueError(f"unknown fault {self._kind!r}")


# ---------------------------------------------------------------------------
# the entries
# ---------------------------------------------------------------------------


class DriverEntry:
    """`IceModelRun`: one step a call."""

    def __init__(self, cfg, *, dtype, device, quiet):
        from cice4_tpu_torch.driver import IceModelRun

        self.run = IceModelRun(cfg, dtype=dtype, log=quiet,
                               device=device).initialize()
        self.runner = self.run

    def step(self, k: int):
        self.run.run(npt=1)

    def context(self):
        return {}

    def forcing_s(self):
        return self.run.timers.totals["Forcing"]


class ComponentEntry:
    """`IceComponent`: one coupling interval a call, from the bank of
    import states, synchronised at its end."""

    def __init__(self, cfg, traffic, *, dtype, device, quiet, bank):
        from cice4_tpu_torch.component import IceComponent

        c = traffic["component"]
        self.comp = IceComponent(cfg, flavor=c["flavor"], dtype=dtype,
                                 log=quiet,
                                 gfdl_surface_flux=c["gfdl_surface_flux"],
                                 device=device).initialize()
        self.runner = self.comp.runner
        self.n_steps = int(c["steps_per_interval"])
        self.bank = bank
        self.exports = None

    def step(self, k: int):
        self.exports = self.comp.run(self.bank[k % len(self.bank)],
                                     n_steps=self.n_steps)
        if self.runner.device.type == "cuda":
            torch.cuda.synchronize(self.runner.device)

    def context(self):
        """What the interval carries in besides the state: the friction
        velocity of the previous interval."""
        return {"u_star": snapshot(self.comp._boundary.u_star)}

    def forcing_s(self):
        return None


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             root: Path = ROOT, device="cuda", dtype=None, overrides=None,
             fault: str | None = None, control: bool = False,
             close_after_sample: bool = False) -> dict:
    """Run cell `name` and return its result line as a dict (keys in the
    order the line prints them).  `overrides` (dotted configuration keys),
    `dtype`, `device`, `fault`, `control` and `close_after_sample` (the
    window closes once its compared step is done) serve the benchmark's
    own tests and calibration; the command line sets none of them."""
    from counts import kernels as kc
    from harness.trace import SPAN, Tracer
    from reference import step as ref_step
    from reference.config import config_from_dict as ref_config
    from reference.state import make_itd_params

    _wl, cfg_file, traffic = cell_pieces(name, root)
    device = torch.device(device)
    dtype = dtype or DTYPES[cfg_file["dtype"]]
    work = Path(tempfile.gettempdir()) / "cice4-bench" / name
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    tree = merged_tree(cfg_file["config"], traffic.get("settings"), {
        "run.history_dir": str(work / "history"),
        "run.restart_dir": str(work / "restart"),
        "run.pointer_file": str(work / "restart" / "ice.restart_file"),
        "forcing.atm_data_dir": str(work / "forcing"),
        "forcing.ocn_data_dir": str(work / "forcing"),
    }, overrides)
    rcfg = ref_config(tree)
    ny, nx = rcfg.domain.ny_global, rcfg.domain.nx_global
    ncat = rcfg.domain.ncat
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        torch.cuda.reset_peak_memory_stats(device)

    # the benchmark's inputs, made before the set-up clock starts: the
    # files the traffic reads, the coupler's bank of imports (on the
    # reference's grid) and the initial state's perturbation
    last_time_s = math.inf
    files = traffic.get("forcing_files")
    if files:
        t0 = time.perf_counter()
        wrote = inputs.write_ncar_files(str(work / "forcing"), seed, files,
                                        ny, nx, year=rcfg.forcing.fyear_init,
                                        device=device)
        last_time_s = wrote["last_time_s"]
        log(f"forcing files: {wrote['bytes']} bytes in "
            f"{time.perf_counter() - t0:.3f} s")
    bank = bank_gen = None
    if traffic["entry"] == "component":
        rgrid = ref_step.Reference.grid_only(tree, device=device)
        bank_gen = inputs.ImportBank(seed, traffic["imports"], rgrid.tlat,
                                     device=device)
        del rgrid
        bank = [bank_gen.interval(k, dtype) for k in range(bank_gen.size)]
    factors = inputs.perturbation(seed, traffic["initial_state"],
                                  make_itd_params(rcfg).hin_max, ncat, ny,
                                  nx, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    def quiet(*_a, **_k):
        return None

    # --- set-up: the program's initialisation and warm-up ------------------
    t_setup = time.perf_counter()
    from cice4_tpu_torch.config import config_from_dict

    cfg = config_from_dict(tree)
    if traffic["entry"] == "component":
        entry = ComponentEntry(cfg, traffic, dtype=dtype, device=device,
                               quiet=quiet, bank=bank)
    else:
        entry = DriverEntry(cfg, dtype=dtype, device=device, quiet=quiet)
    runner = entry.runner
    if files and not getattr(runner.forcing_provider, "available", False):
        raise RuntimeError("the program did not find the forcing files")
    # the seeded state is the benchmark's input: its making is not set-up
    t_paused = time.perf_counter()
    new = inputs.perturb_state(fields_of(runner.state), factors)
    runner.state = runner.state.replace(
        **{k: new[k] for k in ("aicen", "vicen", "vsnon", "eicen", "esnon")})
    start = snapshot(fields_of(runner.state))
    del new
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    paused_s = time.perf_counter() - t_paused
    if fault:
        runner.model = Faulty(runner.model, fault)
    for k in range(int(traffic["warmup_steps"])):
        entry.step(k)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_setup - paused_s
    k0 = int(traffic["warmup_steps"])

    # --- the window ----------------------------------------------------------
    # The step compared with the reference starts at a share of the
    # window drawn from the seed, anywhere in its first four fifths.
    lo, hi = traffic["check"]["window_share"]
    sample_at = seconds * random.Random(int(seed)).uniform(float(lo),
                                                           float(hi))
    sample = None
    trace_n = int(traffic.get("trace", {}).get("steps", 4))
    dt = float(cfg.run.dt) * getattr(entry, "n_steps", 1)
    times = []
    pre = post = context = None
    closed_by = "seconds"
    passes0 = [g["collections"] for g in gc.get_stats()]
    t_win = time.perf_counter()
    i = 0
    while True:
        if runner.calendar.time + dt > last_time_s:
            closed_by = "the last forcing record"
            break
        t = time.perf_counter()
        if sample is None and t - t_win >= sample_at:
            sample = i
            pre = snapshot(fields_of(runner.state))
            pre_istep = runner.calendar.istep
            context = entry.context()
            t = time.perf_counter()
        entry.step(k0 + i)
        times.append(time.perf_counter() - t)
        if i == sample:
            post = snapshot(fields_of(runner.state))
            if isinstance(entry, ComponentEntry):
                context["exports"] = snapshot(entry.exports)
        i += 1
        if sample is not None and (close_after_sample or
                                   time.perf_counter() - t_win >= seconds):
            break
    window_s = time.perf_counter() - t_win
    passes = [g["collections"] - n for g, n in zip(gc.get_stats(), passes0)]
    steps = len(times)
    log(f"window closed by {closed_by}: {steps} steps in {window_s:.6f} s; "
        f"step {sample} compared")
    q = statistics.quantiles(times, n=10, method="inclusive") \
        if steps > 1 else times * 9
    log(f"step ms: p10 {1e3 * q[0]:.3f}, median {1e3 * q[4]:.3f}, p90 "
        f"{1e3 * q[8]:.3f}, max {1e3 * max(times):.3f}; host load "
        f"{os.getloadavg()}; garbage collections by generation {passes}")

    # --- the traced steps, after the window --------------------------------
    # The profiler slows every launch, and keeps slowing them once it has
    # been attached, so it watches steps after the window; the device
    # metrics set the busy time it reads against the window's own steps.
    if trace:
        step_s = statistics.median(
            [t for k, t in enumerate(times) if k != sample] or times)
        tracer = Tracer(device).__enter__()
        forcing0 = entry.forcing_s()
        traced_wall = 0.0
        for j in range(trace_n):
            if runner.calendar.time + dt > last_time_s:
                raise RuntimeError("the forcing ends before the traced steps")
            t = time.perf_counter()
            with torch.profiler.record_function(SPAN):
                entry.step(k0 + i + j)
            traced_wall += time.perf_counter() - t
        tracer.__exit__(None, None, None)
        forcing_traced = (None if forcing0 is None
                          else entry.forcing_s() - forcing0)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    log(f"peak device memory {peak} bytes")

    # --- the program's state is freed; the reference runs ------------------
    del entry, runner, bank
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = ref_step.Reference(tree, device=device)
    if files and not getattr(ref.provider, "available", False):
        raise RuntimeError("the reference did not find the forcing files")
    ref_start = inputs.perturb_state(ref.cold_start(), factors)
    numbers = {"start_gap": check.widest(check.gaps(start, ref_start))}
    if pre is None:
        raise RuntimeError("the window closed before its sampled step")
    if traffic["entry"] == "component":
        imports = bank_gen.interval(k0 + sample)
        rstate, rexports, _u, aux = ref.interval(
            pre, pre_istep, imports, flavor=traffic["component"]["flavor"],
            gfdl=traffic["component"]["gfdl_surface_flux"],
            u_star=context["u_star"], n_steps=int(
                traffic["component"]["steps_per_interval"]),
            start=ref_start)
        numbers.update(state_numbers(post, rstate))
        numbers.update(check.export_numbers(context["exports"], rexports,
                                            ref.grid.tarea))
    else:
        rstate, aux = ref.step(pre, pre_istep, start=ref_start)
        numbers.update(state_numbers(post, rstate))
    limits = traffic["limits"]
    correct = all(check.within(v, limits[k]) for k, (v, _f) in
                  numbers.items())
    controls = None
    if control:
        controls = control_numbers(tree, traffic, pre, pre_istep, context,
                                   ref_start, rstate,
                                   rexports if traffic["entry"] ==
                                   "component" else None, ref.grid.tarea,
                                   factors,
                                   bank_gen if traffic["entry"] ==
                                   "component" else None, k0 + sample,
                                   device)

    # --- the line ------------------------------------------------------------
    out = {"correct": correct, "attempted": steps,
           "failed": 0 if correct else 1}
    m = manifest(root)
    if not trace:
        metrics = {}
        wall = window_s
        values = {
            "sypd": steps * dt / (365.0 * wall),
            "step_ms_p90": 1e3 * statistics.quantiles(
                times, n=10, method="inclusive")[8] if steps > 1
            else 1e3 * times[0],
            "setup_s": setup_s,
        }
        for e in m["end_to_end"]:
            if "workloads" in e and name not in e["workloads"]:
                continue
            metrics[e["name"]] = {"value": values[e["name"]],
                                  "unit": e["unit"]}
        out["metrics"] = metrics
    else:
        shapes = shapes_of(rcfg, start, dtype)
        kb = {k: kc.kernel_bound_ms(k, shapes) for k in kc.KERNELS}
        sb = kc.step_bound_ms(
            shapes, kc.planes(start), kc.planes(
                [getattr(ref.grid, f) for f in ref_grid_fields()]),
            kc.planes([getattr(aux["forcing"], f.name) for f in
                       dataclasses.fields(aux["forcing"])]),
            kc.planes({k: v for k, v in aux["fluxes"].items()
                       if not k.startswith("_")}))
        record = tracer.reduce(traced_wall, trace_n, step_s,
                               forcing_traced, kb, sb)
        moved = {e["name"] for e in m["end_to_end"]
                 if "workloads" not in e or name in e["workloads"]}
        metrics = {}
        for p in m["per_layer"]:
            if "workloads" in p and name not in p["workloads"]:
                continue
            if "workloads" not in p and p["moves"] not in moved:
                continue
            value = metric_reader(p["name"], root).read(record)
            if value is not None:
                metrics[p["name"]] = {"value": value, "unit": p["unit"]}
        out["metrics"] = metrics
        log(f"traced {trace_n} steps in {traced_wall:.6f} s; host syncs by "
            f"site: {record.sync_sites}")
    out["device"] = device_info(device, peak)
    if trace:
        out["device"]["busy_s"] = record.busy_s
        out["device"]["window_s"] = record.wall_s
        out["breakdown"] = record.breakdown
    if controls is not None:
        out["controls"] = controls
    for k, (v, f) in numbers.items():
        log(f"{k}: widest in {f or '(no field)'}")
    out["checks"] = {k: {"value": check.as_json_number(v), "limit": limits[k]}
                     for k, (v, _f) in numbers.items()}
    shutil.rmtree(work, ignore_errors=True)
    return out


def state_numbers(program: dict, reference: dict) -> dict:
    """The state's numbers; the raw state's widest gaps go to the log."""
    log(f"state gaps, cell by cell, tracers alone: "
        f"{check.widest_few(check.gaps(program, reference))}")
    return check.state_numbers(program, reference)


def ref_grid_fields():
    from reference.grid import GRID_FIELDS
    return GRID_FIELDS


def shapes_of(rcfg, start: dict, dtype):
    """The counts' view of the cell: sizes, the remap's tracers and the
    icy cells of the initial state."""
    from counts.kernels import Shapes
    from reference import constants as cn
    from reference.ops.remap import _tracer_meta

    d = rcfg.domain
    meta = _tracer_meta(list(start["trcrn"].keys()), d.nilyr, d.nslyr)
    aicen = start["aicen"]
    aice = aicen.sum(0)
    tmass = cn.rhoi * start["vicen"].sum(0) + cn.rhos * start["vsnon"].sum(0)
    icy = ((aice > 0.001) & (tmass > 0.01)).to(torch.float32)
    dil = torch.nn.functional.max_pool2d(icy[None, None], 3, stride=1,
                                         padding=1)[0, 0] > 0
    return Shapes(ncat=d.ncat, nilyr=d.nilyr, nslyr=d.nslyr,
                  ny=d.ny_global, nx=d.nx_global,
                  itemsize=torch.empty((), dtype=dtype).element_size(),
                  tracers=tuple((n, t) for n, t, _p in meta),
                  integral_order=rcfg.transport.integral_order,
                  ndte=rcfg.dynamics.ndte,
                  icy_category_cells=int((aicen > 0).sum()),
                  icy_t_cells=int(dil.sum()))


def control_numbers(tree, traffic, pre, pre_istep, context, ref_start,
                    rstate, rexports, area, factors, bank_gen, k,
                    device) -> dict:
    """The same numbers with the reference computed in bfloat16 in the
    program's place (the precision below the configuration's float32):
    the calibration's control, which the runs themselves never make."""
    from reference import step as ref_step

    out = {}
    try:
        low = ref_step.Reference(tree, device=device, dtype=torch.bfloat16)
        out["start_gap"] = check.widest(check.gaps(
            inputs.perturb_state(low.cold_start(), factors), ref_start))[0]
        if bank_gen is not None:
            lstate, lexports, _u, _aux = low.interval(
                pre, pre_istep, bank_gen.interval(k),
                flavor=traffic["component"]["flavor"],
                gfdl=traffic["component"]["gfdl_surface_flux"],
                u_star=context["u_star"],
                n_steps=int(traffic["component"]["steps_per_interval"]),
                start=inputs.perturb_state(low.cold_start(), factors))
            out.update({k: v[0] for k, v in check.state_numbers(
                lstate, rstate).items()})
            out.update({k: v[0] for k, v in check.export_numbers(
                lexports, rexports, area).items()})
        else:
            lstate, _aux = low.step(pre, pre_istep, start=inputs.perturb_state(
                low.cold_start(), factors))
            out.update({k: v[0] for k, v in check.state_numbers(
                lstate, rstate).items()})
    except (RuntimeError, TypeError, ValueError) as e:
        out["error"] = f"{type(e).__name__}: {e}"[:300]
    return {k: check.as_json_number(v) if isinstance(v, float) else v
            for k, v in out.items()}


def device_info(device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}


def cache_dirs(root: Path = ROOT):
    """Keep every build and kernel cache inside the checkout, at fixed
    paths: the port builds its kernels in ``build/``."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(root / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
