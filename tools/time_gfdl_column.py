"""Time the GFDL column kernel against the plain GFDL fluxes on the card.

    python tools/time_gfdl_column.py [--workload access-om2-025.coupled]
        [--seed N] [--intervals 24] [--out FILE.json]

On the card, for ACCESS-OM2-025's plane (1080 x 1440) and a 0.1-degree
block (1350 x 1800) of `kernel_check.gfdl_inputs`, in f32 and f64: the
kernel's device ms a launch (CUDA events behind a sleep kernel,
``chip_smoke.device_ms``), its bytes bound (inputs read once, outputs
written once, at 3.35 TB/s) and its share of it, the plain version's wall
ms, device ms and launches a call (``torch.profiler``), the kernel's gaps
to the plain version per output, max |kernel - plain| among them, and the
most Newton passes.  Then the workload's component from its seeded inputs
(the benchmark's bank of imports and initial state) for `--intervals`
coupling intervals after its warm-up: the interval's wall ms, the ``Send``
span's host ms, the most Newton passes over those intervals
(``gfdl_cuda.mo_passes``), and the kernel held
against the plain version at the last interval's inputs.  Prints one JSON
line, with the card's name and power limit (and writes it to `--out` if given).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from cice4_tpu_torch import kernel_check as kc  # noqa: E402
from cice4_tpu_torch.ops import gfdl_cuda  # noqa: E402
from cice4_tpu_torch.ops import gfdl_flux as gf  # noqa: E402

PLANES = {"access-om2-025": (1080, 1440), "access-om2-01 block": (1350, 1800)}
HBM_BYTES_S = 3.35e12


def bound_ms(x) -> float:
    """Each input read once and each output written once."""
    cells = x["tair"].numel()
    elem = x["tair"].element_size()
    nbytes = cells * (len(gfdl_cuda.INPUTS) * elem + 1
                      + len(gfdl_cuda.OUTPUTS) * elem)
    return 1e3 * nbytes / HBM_BYTES_S


def held(x) -> dict:
    """The kernel against the plain version at inputs `x`: its time, the
    plain version's, the gaps and the passes."""
    passes = gfdl_cuda.mo_passes(x["tair"].device)
    passes.zero_()
    kern = gfdl_cuda.gfdl_ocean_fluxes_cuda(**x)
    want = gf._gfdl_ocean_fluxes_plain(**x)
    rep = kc.compare_gfdl(kern, want)
    dev = cs.device_ms(lambda: gfdl_cuda.gfdl_ocean_fluxes_cuda(**x), 50)
    bound = bound_ms(x)

    def plain():
        return gf._gfdl_ocean_fluxes_plain(**x)

    plain()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        plain()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
    _, rows = cs.profiled(plain)
    return {"kernel_device_ms": dev, "bound_ms": bound,
            "pct_of_bound": 100.0 * bound / dev,
            "plain_wall_ms": min(walls),
            "plain_device_ms": sum(r[1] for r in rows),
            "plain_launches": sum(r[2] for r in rows),
            "mo_passes": int(passes),      # read after the timed launches
            "max_abs": {k: float((kern[k] - want[k]).abs().max())
                        for k in want},
            "norm_gap": {k: v["norm_gap"] for k, v in rep.items()},
            "point_gap": {k: v["point_gap"] for k, v in rep.items()},
            "ok": kc.gfdl_ok(rep, x["tair"].dtype)}


def component_run(workload: str, seed: int, intervals: int, device) -> dict:
    """The workload's component from the benchmark's seeded inputs."""
    from harness import cell, inputs
    from reference import step as ref_step
    from reference.config import config_from_dict as ref_config
    from reference.state import make_itd_params

    from cice4_tpu_torch.component import IceComponent
    from cice4_tpu_torch.config import config_from_dict

    _wl, cfg_file, traffic = cell.cell_pieces(workload)
    tree = cell.merged_tree(cfg_file["config"], traffic.get("settings"),
                            {"run.history_dir": str(Path(
                                tempfile.gettempdir()) / "gfdl_history")})
    dtype = cell.DTYPES[cfg_file["dtype"]]
    rcfg = ref_config(tree)
    ny, nx = rcfg.domain.ny_global, rcfg.domain.nx_global
    rgrid = ref_step.Reference.grid_only(tree, device=device)
    bank_gen = inputs.ImportBank(seed, traffic["imports"], rgrid.tlat,
                                 device=device)
    bank = [bank_gen.interval(k, dtype) for k in range(bank_gen.size)]
    del rgrid, bank_gen
    factors = inputs.perturbation(seed, traffic["initial_state"],
                                  make_itd_params(rcfg).hin_max,
                                  rcfg.domain.ncat, ny, nx, device=device)
    c = traffic["component"]
    comp = IceComponent(config_from_dict(tree), flavor=c["flavor"],
                        dtype=dtype, log=lambda *a: None,
                        gfdl_surface_flux=c["gfdl_surface_flux"],
                        device=device).initialize()
    r = comp.runner
    new = inputs.perturb_state(cell.fields_of(r.state), factors)
    r.state = r.state.replace(**{k: new[k] for k in (
        "aicen", "vicen", "vsnon", "eicen", "esnon")})
    del new, factors
    seen = {}
    real = gf.gfdl_ocean_fluxes

    def capture(**kw):
        seen.update(kw)
        return real(**kw)

    n_steps = int(c["steps_per_interval"])
    k0 = int(traffic["warmup_steps"])
    for k in range(k0):
        comp.run(bank[k % len(bank)], n_steps=n_steps)
    torch.cuda.synchronize(device)
    t = r.timers
    send0 = t.host_ns.get("Send", 0)
    passes = gfdl_cuda.mo_passes(device)
    passes.zero_()
    launches0 = gf.gfdl_ocean_fluxes.launches
    times = []
    for k in range(k0, k0 + intervals):
        t0 = time.perf_counter()
        comp.run(bank[k % len(bank)], n_steps=n_steps)
        torch.cuda.synchronize(device)
        times.append(1e3 * (time.perf_counter() - t0))
    out = {"intervals": intervals,
           "interval_ms_median": statistics.median(times),
           "send_host_ms": 1e-6 * (t.host_ns["Send"] - send0) / intervals,
           "mo_passes": int(passes),
           "gfdl_launches_an_interval":
               (gf.gfdl_ocean_fluxes.launches - launches0) / intervals}
    # one interval more, its GFDL inputs captured (the coupler looks the
    # function up at each call)
    gf.gfdl_ocean_fluxes = capture
    try:
        comp.run(bank[(k0 + intervals) % len(bank)], n_steps=n_steps)
    finally:
        gf.gfdl_ocean_fluxes = real
    x = {k: v for k, v in seen.items() if k in (*gfdl_cuda.INPUTS, "tmask")}
    out["at_the_cell_inputs"] = held(x)
    out["open_water_cells"] = int(x["tmask"].sum())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="access-om2-025.coupled")
    ap.add_argument("--seed", type=int, default=2_147_482_001)
    ap.add_argument("--intervals", type=int, default=24)
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_gfdl_column: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    line = {"card": cs.card_line(), "planes": {}}
    for name, (ny, nx) in PLANES.items():
        for dtype in (torch.float32, torch.float64):
            x = kc.gfdl_inputs(ny, nx, seed=7, device=device, dtype=dtype)
            line["planes"][f"{name} {str(dtype)[6:]}"] = held(x)
            print(json.dumps({name: line["planes"][
                f"{name} {str(dtype)[6:]}"]}), flush=True)
    line["component"] = component_run(args.workload, args.seed,
                                      args.intervals, device)
    print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(line, indent=1))
    return 0 if all(v["ok"] for v in line["planes"].values()) and \
        line["component"]["at_the_cell_inputs"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
