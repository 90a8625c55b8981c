"""Step the ACCESS component on one block of a mesh a process, from a
benchmark cell's seeded inputs, and report what the benchmark's line does
not: per rank its interval times, its counters a step (``exchanges``,
``collectives``, ``ridge_passes``), its regions' host time a step (the
``Exchange`` spans among them), its peak device memory, and the remap's
largest Courant number of the run, max(|u| / dxu, |v| / dyu) * dt over the
block's U points, the most a departure point moves in cells.

    python tools/mesh_component_run.py --workload access-om2-01.coupled \
        --intervals 60 [--seed N] [--ranks 4] [--device cuda|cpu] \
        [--set sec.key=val ...]

starts one process a rank (rank r on card r, NCCL; gloo on the CPU) and
prints one JSON line a rank, then the run's largest Courant number.
Everything after the intervals (the Courant number's reduction, the
report) is outside their times.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]


def rank_main(args) -> int:
    import torch
    import torch.distributed as dist

    from harness import cell, inputs
    from reference.config import config_from_dict as ref_config
    from reference.state import make_itd_params

    from cice4_tpu_torch.component import IceComponent
    from cice4_tpu_torch.config import config_from_dict

    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    wl, cfg_file, traffic = cell.cell_pieces(args.workload)
    over = dict(kv.split("=", 1) for kv in args.set or [])
    over = {k: json.loads(v) if v[:1] in "0123456789-[{tf" else v
            for k, v in over.items()}
    tree = cell.merged_tree(cfg_file["config"], traffic.get("settings"),
                            {"run.history_dir": os.path.join(
                                tempfile.gettempdir(), f"mesh-run-{rank}")},
                            over)
    dtype = cell.DTYPES[cfg_file["dtype"]]
    c = traffic["component"]
    comp = IceComponent(config_from_dict(tree), flavor=c["flavor"],
                        dtype=dtype, log=lambda *a: None,
                        gfdl_surface_flux=c["gfdl_surface_flux"],
                        device=device)
    rcfg = ref_config(tree)
    ny, nx = rcfg.domain.ny_global, rcfg.domain.nx_global
    mesh = comp.mesh
    rows, cols = mesh.block_slices(mesh.local_blocks[0], ny, nx)
    blk = (rows.start, rows.stop, cols.start, cols.stop)
    from reference.grid import make_grid as ref_grid
    tlat = ref_grid(rcfg, device=device, dtype=torch.float64).tlat
    bank = inputs.ImportBank(args.seed, traffic["imports"], tlat,
                             device=device, block=blk)
    del tlat
    imports = [bank.interval(k, dtype) for k in range(bank.size)]
    factors = cell.block_of(inputs.perturbation(
        args.seed, traffic["initial_state"], make_itd_params(rcfg).hin_max,
        rcfg.domain.ncat, ny, nx, device=device), blk, ny, nx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    comp.initialize()
    r = comp.runner
    new = inputs.perturb_state(cell.fields_of(r.state), factors)
    r.state = r.state.replace(**{k: new[k] for k in (
        "aicen", "vicen", "vsnon", "eicen", "esnon")})
    del new, factors

    def interval(k):
        comp.run(imports[k % len(imports)], n_steps=int(
            c["steps_per_interval"]))
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    k0 = int(traffic["warmup_steps"])
    for k in range(k0):
        interval(k)
    setup_s = time.perf_counter() - t0
    grid = r.grid
    dt = float(r.cfg.run.dt)
    host0, counters0 = dict(r.timers.host_ns), r.timers.counters
    courant = []
    times = []
    for k in range(k0, k0 + args.intervals):
        t = time.perf_counter()
        interval(k)
        times.append(time.perf_counter() - t)
        s = r.state
        courant.append(torch.maximum(s.uvel.abs() / grid.dxu,
                                     s.vvel.abs() / grid.dyu).amax() * dt)
    n = args.intervals
    counters = {k: (v - counters0.get(k, 0)) / n
                for k, v in r.timers.counters.items()}
    spans = {p: 1e-6 * (v - host0.get(p, 0)) / n
             for p, v in r.timers.host_ns.items()}
    worst = torch.stack(courant).amax().double()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    q = statistics.quantiles(times, n=10, method="inclusive")
    line = {"rank": rank, "block": blk, "setup_s": setup_s,
            "interval_ms": {"median": 1e3 * q[4], "p90": 1e3 * q[8],
                            "min": 1e3 * min(times),
                            "max": 1e3 * max(times)},
            "counters_a_step": counters,
            "host_ms_a_step": {p: v for p, v in sorted(spans.items())
                               if v > 0.05},
            "courant_max": float(worst), "peak_bytes": int(peak),
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu")}
    print(json.dumps(line), flush=True)
    w = worst.to(device)
    dist.all_reduce(w, op=dist.ReduceOp.MAX)
    if rank == 0:
        print(json.dumps({"courant_max_all_ranks": float(w)}), flush=True)
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="access-om2-01.coupled")
    ap.add_argument("--seed", type=int, default=4_000_000_001)
    ap.add_argument("--intervals", type=int, default=60)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", metavar="sec.key=val")
    ap.add_argument("--rank", action="store_true", help=argparse.SUPPRESS)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if args.rank:
        return rank_main(args)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(args.ranks):
        env = dict(os.environ, CICE4_DISTRIBUTED="1", RANK=str(r),
                   WORLD_SIZE=str(args.ranks), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--rank", *argv], env=env))
    codes = [p.wait() for p in procs]
    return max(codes, key=abs)


if __name__ == "__main__":
    sys.exit(main())
