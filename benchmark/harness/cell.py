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
as a coupler that passes the exports on must wait for them); any other
entry is the file ``benchmark/entries/<entry>.py`` (see ``load_entry``).

A cell on several cards runs one rank a card (``harness/ranks.py``):
each rank's entry holds one block of the grid, all ranks run the
window's steps together, and the snapshots the check compares are
gathered to rank 0.  The reference then runs on rank 0, whole or, where
the traffic sets ``check.bands``, in full-width bands spread over the
ranks (``harness/bands.py``).
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
from harness.ranks import SOLO

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
DTYPES = {"float32": torch.float32, "float64": torch.float64}
# top-level module names the program must not load (the JAX package it
# was ported from, and JAX itself)
FORBIDDEN = ("jax", "jaxlib", "flax", "cice4_tpu")
# the window's decisions, rank 0's, for the step to come
STEP, SAMPLE, CLOSE = 0, 1, 2
# the state's fields, as the port's State names them
STATE_FIELDS = ("aicen", "vicen", "vsnon", "eicen", "esnon", "tsfcn",
                "trcrn", "uvel", "vvel", "stressp", "stressm", "stress12",
                "iceumask", "sst", "frzmlt", "scale_factor", "strocnxT",
                "strocnyT", "swn")


def log(*parts):
    # one write a line, so that the lines of several ranks do not mix
    sys.stderr.write(" ".join(map(str, parts)) + "\n")
    sys.stderr.flush()


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


def load_entry(name: str, root: Path = ROOT):
    """The entry module ``benchmark/entries/<name>.py``, or None for the
    built-in ``driver`` and ``component``.

    Such a module defines ``Entry(cfg, traffic, *, dtype, device, quiet,
    bank)``, built inside the set-up clock, with ``runner`` (``state``,
    ``model`` and ``calendar``: the state it steps, the model a fault
    wraps, the calendar that counts steps), ``step(k)`` (one step or
    coupling interval, ending in a synchronisation of its card),
    ``context()`` and ``forcing_s()`` as the built-in entries have them,
    and, for a coupled cell, ``n_steps`` and ``exports``.  On a cell of
    several cards it also defines ``block(ny, nx) -> (j0, j1, i0, i1)``:
    the rows and columns of the global grid that this rank's entry will
    hold, which the harness asks before the set-up clock starts, with
    the process group up.  The state, the exports and the friction
    velocity of the context are then the block's."""
    if name in ("driver", "component"):
        return None
    path = root / "benchmark" / "entries" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_entry_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def block_of(obj, blk, ny: int, nx: int):
    """A copy of `obj`'s block `blk` = (j0, j1, i0, i1): every tensor of
    trailing (ny, nx) axes cut to it, nested dicts followed."""
    if isinstance(obj, dict):
        return {k: block_of(v, blk, ny, nx) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor) and obj.dim() >= 2 \
            and tuple(obj.shape[-2:]) == (ny, nx):
        j0, j1, i0, i1 = blk
        return obj[..., j0:j1, i0:i1].clone()
    return obj


def to_host(obj):
    """`obj` with every tensor on the host, nested dicts followed."""
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    return obj


def gather_global(group, obj, blk, ny: int, nx: int):
    """Rank 0: the whole grid's `obj`, on the host, from every rank's
    block of it (tensors of two axes or more are blocks; other values are
    rank 0's).  The other ranks get None."""
    parts = group.gather((tuple(blk), to_host(obj)))
    if parts is None:
        return None
    blocks = [p[0] for p in parts]
    if sum((j1 - j0) * (i1 - i0) for j0, j1, i0, i1 in blocks) != ny * nx:
        raise RuntimeError(f"the ranks' blocks {blocks} do not tile the "
                           f"{ny}x{nx} grid")

    def join(values):
        first = values[0]
        if isinstance(first, dict):
            return {k: join([v[k] for v in values]) for k in first}
        if isinstance(first, torch.Tensor) and first.dim() >= 2:
            out = torch.empty(tuple(first.shape[:-2]) + (ny, nx),
                              dtype=first.dtype)
            for (j0, j1, i0, i1), v in zip(blocks, values):
                out[..., j0:j1, i0:i1] = v
            return out
        return first
    return join([p[1] for p in parts])


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
             close_after_sample: bool = False, group=None,
             also_bands=()) -> dict | None:
    """Run cell `name` and return its result line as a dict (keys in the
    order the line prints them).  `overrides` (dotted configuration keys),
    `dtype`, `device`, `fault`, `control` and `close_after_sample` (the
    window closes once its compared step is done) serve the benchmark's
    own tests and calibration; the command line sets none of them.

    `group` is the run's ranks (``harness.ranks``; one process by
    default), each calling this with its own `device`; only rank 0
    returns the line, the others None.  The reference runs whole, or in
    the traffic's ``check.bands``; each of `also_bands` computes it once
    more in that many bands, for the calibration to compare
    (``band_checks`` in the line)."""
    from counts import kernels as kc
    from harness import bands as banding
    from harness.trace import SPAN, Tracer
    from reference import step as ref_step
    from reference.config import config_from_dict as ref_config
    from reference.state import make_itd_params

    group = group or SOLO
    _wl, cfg_file, traffic = cell_pieces(name, root)
    device = torch.device(device)
    dtype = dtype or DTYPES[cfg_file["dtype"]]
    work = Path(tempfile.gettempdir()) / "cice4-bench" / name
    if group.rank == 0:
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
    # the ranks' own files apart; the forcing files rank 0 writes, shared
    own = work if group.size == 1 else work / f"rank{group.rank}"
    tree = merged_tree(cfg_file["config"], traffic.get("settings"), {
        "run.history_dir": str(own / "history"),
        "run.restart_dir": str(own / "restart"),
        "run.pointer_file": str(own / "restart" / "ice.restart_file"),
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
    if files and group.rank == 0:
        t0 = time.perf_counter()
        wrote = inputs.write_ncar_files(str(work / "forcing"), seed, files,
                                        ny, nx, year=rcfg.forcing.fyear_init,
                                        device=device)
        last_time_s = wrote["last_time_s"]
        log(f"forcing files: {wrote['bytes']} bytes in "
            f"{time.perf_counter() - t0:.3f} s")
    if group.size > 1:
        last_time_s = group.broadcast(last_time_s)
    # this rank's block of the grid: the whole grid but on several cards
    entry_mod = load_entry(traffic["entry"], root)
    blk = whole = (0, ny, 0, nx)
    if group.size > 1:
        if entry_mod is None or not hasattr(entry_mod, "block"):
            raise ValueError(f"cell {name} runs on {group.size} cards, and "
                             f"its entry {traffic['entry']!r} holds no block")
        blk = tuple(int(v) for v in entry_mod.block(ny, nx))
        log(f"rank {group.rank} of {group.size} on {device}: rows "
            f"{blk[0]}:{blk[1]}, columns {blk[2]}:{blk[3]}")
    coupled = "component" in traffic
    bank = bank_gen = None
    if coupled:
        rgrid = ref_step.Reference.grid_only(tree, device=device)
        # on several cards the block's imports alone; rank 0 makes the
        # whole grid's generator for the reference after the window
        bank_gen = inputs.ImportBank(seed, traffic["imports"], rgrid.tlat,
                                     device=device,
                                     block=None if blk == whole else blk)
        del rgrid
        bank = [bank_gen.interval(k, dtype) for k in range(bank_gen.size)]
        if blk != whole:
            bank_gen = None
    factors = inputs.perturbation(seed, traffic["initial_state"],
                                  make_itd_params(rcfg).hin_max, ncat, ny,
                                  nx, device=device)
    factors_all = factors
    if blk != whole:
        factors_all = ({k: v.cpu() for k, v in factors.items()}
                       if group.rank == 0 else None)
        factors = block_of(factors, blk, ny, nx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        if blk != whole:
            # the whole grid's tables made to cut the block are freed:
            # the peak is the block's
            torch.cuda.reset_peak_memory_stats(device)

    def quiet(*_a, **_k):
        return None

    # --- set-up: the program's initialisation and warm-up ------------------
    t_setup = time.perf_counter()
    from cice4_tpu_torch.config import config_from_dict

    cfg = config_from_dict(tree)
    if entry_mod is not None:
        entry = entry_mod.Entry(cfg, traffic, dtype=dtype, device=device,
                                quiet=quiet, bank=bank)
    elif traffic["entry"] == "component":
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
    if group.size > 1:
        win = window_ranks(entry, group, k0=k0, dt=dt, seconds=seconds,
                           sample_at=sample_at, last_time_s=last_time_s,
                           close_after_sample=close_after_sample,
                           coupled=coupled)
        (times, waits, sample, pre, pre_istep, post, context, closed_by,
         window_s, i) = (win[k] for k in (
             "times", "waits", "sample", "pre", "pre_istep", "post",
             "context", "closed_by", "window_s", "steps"))
    else:
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
                if coupled:
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
            if group.size > 1:
                group.decide(STEP)
            traced_wall += time.perf_counter() - t
        tracer.__exit__(None, None, None)
        forcing_traced = (None if forcing0 is None
                          else entry.forcing_s() - forcing0)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    log(f"peak device memory {peak} bytes")

    # --- on several ranks: their readings and blocks, gathered to rank 0 --
    own_start = start
    if group.size > 1:
        if pre is None:
            raise RuntimeError("the window closed before its sampled step")
        wait_s = statistics.fmean(waits)
        log(f"rank {group.rank}: {steps} steps, set-up {setup_s:.6f} s, peak "
            f"{peak} bytes, all-reduce wait {1e3 * wait_s:.6f} ms a step "
            f"(largest {1e3 * max(waits):.6f})")
        seen = group.gather({"steps": steps, "setup_s": setup_s,
                             "peak": int(peak), "wait_s": wait_s})
        start, pre, post, context = (
            gather_global(group, x, blk, ny, nx)
            for x in (start, pre, post, context))
        if group.rank == 0:
            if len({r["steps"] for r in seen}) != 1:
                raise RuntimeError(f"the ranks ran different steps: {seen}")
            setup_s = max(r["setup_s"] for r in seen)
            peak = max(r["peak"] for r in seen)
            factors = factors_all
            log(f"ranks: set-up {[r['setup_s'] for r in seen]} s, peak "
                f"{[r['peak'] for r in seen]} bytes, all-reduce wait "
                f"{[1e3 * r['wait_s'] for r in seen]} ms a step")
        del win

    # --- the program's state is freed; the reference runs ------------------
    del entry, runner, bank
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    m = manifest(root)

    def read_trace(counts):
        """This rank's traced steps against its own block: the record
        and the per-layer metrics read from it; `counts` the planes of
        the reference's grid, forcing and fluxes."""
        shapes = shapes_of(rcfg, own_start, dtype)
        if group.size > 1:
            log(f"rank {group.rank}: bounds against {shapes.ny}x{shapes.nx} "
                f"cells")
        kb = {k: kc.kernel_bound_ms(k, shapes) for k in kc.KERNELS}
        sb = kc.step_bound_ms(shapes, kc.planes(own_start), *counts)
        record = tracer.reduce(traced_wall, trace_n, step_s,
                               forcing_traced, kb, sb)
        if group.size > 1:
            record.wait_s = wait_s
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
        log(f"traced {trace_n} steps in {traced_wall:.6f} s; host syncs by "
            f"site: {record.sync_sites}")
        return record, metrics

    if group.rank != 0:
        # the bands rank 0 deals out, then this rank's trace
        banding.serve(group, ref_config(tree).with_values(
            **{"run.guards": False}), device)
        if trace:
            record, metrics = read_trace(group.broadcast(None))
            log(f"rank {group.rank} metrics: {metrics}")
            group.gather((metrics, record.busy_s, record.wall_s))
        return None

    ref = ref_step.Reference(tree, device=device)
    if files and not getattr(ref.provider, "available", False):
        raise RuntimeError("the reference did not find the forcing files")
    if coupled and bank_gen is None:
        bank_gen = inputs.ImportBank(seed, traffic["imports"], ref.grid.tlat,
                                     device=device)
    ref_start = inputs.perturb_state(ref.cold_start(), factors)
    numbers = {"start_gap": check.widest(check.gaps(start, ref_start))}
    if pre is None:
        raise RuntimeError("the window closed before its sampled step")
    n_bands = traffic["check"].get("bands")

    def banded(n):
        return banding.Banded(int(n), group, log) if n else None

    def compare(stepper):
        """The numbers of the compared step against the reference's,
        whole or in the bands of `stepper`."""
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            held = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        if coupled:
            imports = bank_gen.interval(k0 + sample)
            rstate, rexports, _u, aux = ref.interval(
                pre, pre_istep, imports,
                flavor=traffic["component"]["flavor"],
                gfdl=traffic["component"]["gfdl_surface_flux"],
                u_star=context["u_star"], n_steps=int(
                    traffic["component"]["steps_per_interval"]),
                start=ref_start, bands=stepper)
            got = state_numbers(post, rstate)
            got.update(check.export_numbers(context["exports"], rexports,
                                            ref.grid.tarea))
        else:
            rstate, aux = ref.step(pre, pre_istep, start=ref_start,
                                   bands=stepper)
            rexports = None
            got = state_numbers(post, rstate)
        took = {"seconds": time.perf_counter() - t0, "cells": ny * nx,
                "peak_bytes": 0}
        if stepper is not None:
            # the largest band's, each measured on its own card
            big = max(stepper.records[-1]["bands_run"],
                      key=lambda r: r["peak_bytes"])
            took.update(peak_bytes=big["peak_bytes"], cells=big["cells"])
        elif device.type == "cuda":
            took["peak_bytes"] = torch.cuda.max_memory_allocated(device) - held
        log(f"reference, {'whole' if stepper is None else f'{stepper.n} bands'}"
            f": {took['seconds']:.3f} s in all; {took['peak_bytes']} bytes "
            f"over its holdings at most, over {took['cells']} cells "
            f"({took['peak_bytes'] / took['cells']:.1f} a cell)")
        return got, rstate, rexports, aux, took

    got, rstate, rexports, aux, took = compare(banded(n_bands))
    numbers.update(got)
    limits = traffic["limits"]
    correct = all(check.within(v, limits[k]) for k, (v, _f) in
                  numbers.items())
    band_checks = {}
    for n in also_bands:
        stepper = banded(n)
        extra, _s, _x, _a, took_n = compare(stepper)
        band_checks[str(n)] = {
            "checks": {k: check.as_json_number(v) for k, (v, _f) in
                       extra.items()},
            "reference": took_n, "bands": stepper.records}
    controls = None
    if control:
        controls = control_numbers(tree, traffic, pre, pre_istep, context,
                                   ref_start, rstate,
                                   rexports if coupled else None,
                                   ref.grid.tarea, factors,
                                   bank_gen if coupled else None, k0 + sample,
                                   device, bands=banded(n_bands))
    banding.stop(group)

    # --- the line ------------------------------------------------------------
    out = {"correct": correct, "attempted": steps,
           "failed": 0 if correct else 1}
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
        record, metrics = read_trace(group.broadcast((
            kc.planes([getattr(ref.grid, f) for f in ref_grid_fields()]),
            kc.planes([getattr(aux["forcing"], f.name) for f in
                       dataclasses.fields(aux["forcing"])]),
            kc.planes({k: v for k, v in aux["fluxes"].items()
                       if not k.startswith("_")}))))
        busy_s, wall_s = record.busy_s, record.wall_s
        if group.size > 1:
            # each rank's readings, and their mean over the ranks
            every = group.gather((metrics, busy_s, wall_s))
            for r, (mr, b, w) in enumerate(every):
                log(f"rank {r}: busy_s {b}, window_s {w}, metrics "
                    f"{ {k: v['value'] for k, v in mr.items()} }")
            metrics = {k: {"value": statistics.fmean(
                [e[0][k]["value"] for e in every if k in e[0]]),
                "unit": v["unit"]} for k, v in metrics.items()}
            busy_s = statistics.fmean(e[1] for e in every)
            wall_s = statistics.fmean(e[2] for e in every)
        out["metrics"] = metrics
    out["device"] = device_info(device, peak, group.size)
    if trace:
        out["device"]["busy_s"] = busy_s
        out["device"]["window_s"] = wall_s
        out["breakdown"] = record.breakdown
    if controls is not None:
        out["controls"] = controls
    if band_checks:
        out["reference"] = took
        out["band_checks"] = band_checks
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
    icy cells of the initial state `start` (the whole grid's, or a
    rank's block)."""
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
                  ny=aicen.shape[-2], nx=aicen.shape[-1],
                  itemsize=torch.empty((), dtype=dtype).element_size(),
                  tracers=tuple((n, t) for n, t, _p in meta),
                  integral_order=rcfg.transport.integral_order,
                  ndte=rcfg.dynamics.ndte,
                  icy_category_cells=int((aicen > 0).sum()),
                  icy_t_cells=int(dil.sum()))


def control_numbers(tree, traffic, pre, pre_istep, context, ref_start,
                    rstate, rexports, area, factors, bank_gen, k,
                    device, bands=None) -> dict:
    """The same numbers with the reference computed in bfloat16 in the
    program's place (the precision below the configuration's float32):
    the calibration's control, which the runs themselves never make;
    in the bands of `bands` where given."""
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
                start=inputs.perturb_state(low.cold_start(), factors),
                bands=bands)
            out.update({k: v[0] for k, v in check.state_numbers(
                lstate, rstate).items()})
            out.update({k: v[0] for k, v in check.export_numbers(
                lexports, rexports, area).items()})
        else:
            lstate, _aux = low.step(pre, pre_istep, start=inputs.perturb_state(
                low.cold_start(), factors), bands=bands)
            out.update({k: v[0] for k, v in check.state_numbers(
                lstate, rstate).items()})
    except (RuntimeError, TypeError, ValueError) as e:
        out["error"] = f"{type(e).__name__}: {e}"[:300]
    return {k: check.as_json_number(v) if isinstance(v, float) else v
            for k, v in out.items()}


def device_info(device, peak: int, count: int = 1) -> dict:
    """`count` cards of `device`'s kind, `peak` the fullest one's."""
    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count, "memory_peak_bytes": int(peak)}


def window_ranks(entry, group, *, k0, dt, seconds, sample_at, last_time_s,
                 close_after_sample, coupled) -> dict:
    """The window on several ranks.  After each step every rank joins one
    all-reduce, the coupler's wait for every rank, which carries rank 0's
    decision for the next step: a step, the compared step, or the close;
    so every rank runs the same steps and snapshots the same one.  A
    step's time runs from its start to the all-reduce's end on this
    rank's clock; `waits` holds each step's time in the all-reduce."""
    runner = entry.runner
    w = {"times": [], "waits": [], "sample": None, "pre": None,
         "pre_istep": None, "post": None, "context": None,
         "closed_by": "seconds" if group.rank == 0 else "rank 0"}

    def choose():
        if group.rank != 0:
            return STEP
        now = time.perf_counter() - t_win
        if w["sample"] is not None:
            if close_after_sample or now >= seconds:
                return CLOSE
        if runner.calendar.time + dt > last_time_s:
            w["closed_by"] = "the last forcing record"
            return CLOSE
        if w["sample"] is None and now >= sample_at:
            return SAMPLE
        return STEP

    group.decide(STEP)          # every rank's set-up is done
    t_win = time.perf_counter()
    code = group.decide(choose())
    i = 0
    while code != CLOSE:
        t = time.perf_counter()
        if code == SAMPLE:
            w.update(sample=i, pre=snapshot(fields_of(runner.state)),
                     pre_istep=runner.calendar.istep,
                     context=entry.context())
            t = time.perf_counter()
        entry.step(k0 + i)
        t_step = time.perf_counter()
        code = group.decide(choose())
        t_end = time.perf_counter()
        w["times"].append(t_end - t)
        w["waits"].append(t_end - t_step)
        if i == w["sample"]:
            w["post"] = snapshot(fields_of(runner.state))
            if coupled:
                w["context"]["exports"] = snapshot(entry.exports)
        i += 1
    w["window_s"] = time.perf_counter() - t_win
    w["steps"] = i
    return w


def forbidden_loaded() -> list:
    """The forbidden top-level modules this process has loaded."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def emit(out: dict, loaded) -> int:
    """Print a run's result: the checks as the last lines of standard
    error, the line as the last of standard output; none, and exit code
    3, where the run loaded a forbidden module."""
    if loaded:
        print(f"forbidden modules loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out, allow_nan=False), flush=True)
    return 0


def cache_dirs(root: Path = ROOT):
    """Keep every build and kernel cache inside the checkout, at fixed
    paths: the port builds its kernels in ``build/``."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(root / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
