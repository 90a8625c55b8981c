"""Run the model decomposed over processes: the multi-process entry.

    CICE4_DISTRIBUTED=1 CICE4_COORDINATOR=127.0.0.1:<port> \\
    CICE4_NUM_PROCESSES=2 CICE4_PROCESS_ID=<0|1> \\
    python -m cice4_tpu_torch.parallel.launch --preset gx1 --steps 2 \\
        [--mesh 1x2] [--device cuda|cpu] [--backend gloo|nccl] [--f64] \\
        [--set sec.key=val ...] [--restart-dir DIR] [--save FILE.npz]

(the analogue of the JAX package's two-process launch,
``tests/test_multiprocess.py:13-18``; torchrun's ``RANK``/``WORLD_SIZE``
work too).  Each process joins the group (:func:`~cice4_tpu_torch.
parallel.mesh.init_distributed`), builds the named config's grid and
cold-start state (a preset of the CLI with its ``--set`` overrides),
owns its blocks of the mesh (default: one block per
process) and runs `--steps` steps of `ice_step` on them under the
analytic forcing, then prints ``CHECKSUM <rank> aice=... e=... u2=...
vice=...``: sums over the blocks, in block order, so that every
decomposition into processes of one mesh prints the same digits.  With
`--restart-dir` it writes the sharded restart, and process 0 reads it
back and prints ``RESTART_OK`` if its sums are the run's.  With `--save`
process 0 writes the gathered final state (NumPy ``.npz``).  Without the
flag it runs all blocks in this one process.

It runs on the card unless given ``--device cpu``; a CUDA device asked
for and absent is an error (exit status 2), as is a backend that fails
to initialise.
"""

from __future__ import annotations

import argparse
import sys

import torch


def checksums(state, mesh) -> dict:
    """The run's sums over every block (in block order), each block
    calling it inside :meth:`Mesh.run`."""
    from cice4_tpu_torch.parallel.halo import global_sum

    return dict(zip(("aice", "vice", "u2", "e"),
                    global_sum(_sums(state)).tolist()))


def _sums(state):
    """The checksums' terms of one state, summed in float64."""
    return torch.stack([state.aicen.double().sum(), state.vicen.double().sum(),
                        (state.uvel.double() ** 2).sum(),
                        state.eicen.double().sum()])


def run_decomposed(cfg, steps, mesh, *, device, dtype=torch.float32,
                   yday0=80.0):
    """`steps` steps of the config's cold start on the blocks this process
    owns, under the analytic forcing from day `yday0`.  Returns (the
    final block states in ``mesh.local_blocks`` order, the block models,
    the checksums)."""
    from cice4_tpu_torch.convert import scatter_blocks
    from cice4_tpu_torch.grid import make_grid
    from cice4_tpu_torch.io.forcing_data import AnalyticForcing
    from cice4_tpu_torch.model import Model
    from cice4_tpu_torch.state import init_state, make_itd_params

    grid = make_grid(cfg, device=device, dtype=dtype)
    state = init_state(cfg, grid, make_itd_params(cfg), device=device,
                       dtype=dtype)
    forcing = AnalyticForcing(cfg, grid, device=device, dtype=dtype)
    grids = scatter_blocks(grid, mesh)
    models = [Model(cfg, g) for g in grids]
    states = scatter_blocks(state, mesh)
    for n in range(steps):
        yday = yday0 + n * cfg.run.dt / 86400.0
        fb = scatter_blocks(forcing(yday, 0.0), mesh)

        def step(b, yday=yday, fb=fb):
            k = mesh.local_blocks.index(b)
            return models[k](states[k], fb[k], yday, 0.0)[0]

        states = mesh.run(step)
    sums = mesh.run(
        lambda b: checksums(states[mesh.local_blocks.index(b)], mesh))[0]
    return states, models, sums


def main(argv=None):
    p = argparse.ArgumentParser(prog="cice4_tpu_torch.parallel.launch",
                                description=__doc__.split("\n\n")[1])
    p.add_argument("--preset", choices=["gx1", "gx3", "col"], default=None)
    p.add_argument("--set", action="append", metavar="sec.key=val",
                   help="dotted config override, repeatable")
    p.add_argument("--steps", type=int, default=1)
    p.add_argument("--mesh", default=None,
                   help="PYxPX (default: one block per process)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None,
                   help="torch.distributed backend (default nccl on cuda, "
                        "gloo on cpu)")
    p.add_argument("--f64", action="store_true")
    p.add_argument("--restart-dir", default=None)
    p.add_argument("--save", default=None)
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("cice4_tpu_torch.parallel.launch: no CUDA device; give "
              "--device cpu to run on the CPU", file=sys.stderr)
        return 2

    import torch.distributed as dist

    from cice4_tpu_torch.cli import _load_config
    from cice4_tpu_torch.parallel.mesh import (Mesh, init_distributed,
                                               make_mesh)

    init_distributed(args.backend, device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if args.mesh:
        py, px = (int(v) for v in args.mesh.lower().split("x"))
        mesh = Mesh(py, px)
    else:
        mesh = make_mesh()
    cfg = _load_config(argparse.Namespace(preset=args.preset, config=None,
                                          set=args.set))
    dtype = torch.float64 if args.f64 else torch.float32
    states, _models, sums = run_decomposed(cfg, args.steps, mesh,
                                           device=device, dtype=dtype)
    backend = dist.get_backend() if dist.is_initialized() else "none"
    print(f"MESH {rank} {mesh.py}x{mesh.px} blocks "
          f"{list(mesh.local_blocks)} backend {backend}", flush=True)
    print(f"CHECKSUM {rank} " + " ".join(
        f"{k}={v:.17e}" for k, v in sorted(sums.items())), flush=True)

    if args.save:
        from cice4_tpu_torch.convert import allgather_blocks, to_arrays

        full = mesh.run(lambda b: allgather_blocks(
            states[mesh.local_blocks.index(b)], mesh))[0]
        if rank == 0:
            import numpy as np

            flat = {}
            for k, v in to_arrays(full).items():
                if isinstance(v, dict):
                    flat.update({f"{k}.{kk}": vv for kk, vv in v.items()})
                elif v is not None:
                    flat[k] = v
            np.savez(args.save, **flat)

    if args.restart_dir:
        from cice4_tpu_torch.io.restart import (dump_restart_sharded,
                                                load_restart_sharded)

        dump_restart_sharded(states, mesh, args.restart_dir,
                             istep=args.steps,
                             time=args.steps * cfg.run.dt)
        if dist.is_initialized():
            dist.barrier()
        if rank == 0:
            from cice4_tpu_torch.grid import make_grid
            from cice4_tpu_torch.state import init_state, make_itd_params

            grid = make_grid(cfg, device=device, dtype=dtype)
            template = init_state(cfg, grid, make_itd_params(cfg),
                                  device=device, dtype=dtype)
            loaded, manifest = load_restart_sharded(args.restart_dir,
                                                    template)
            if manifest["nprocs"] != mesh.nprocs:
                raise SystemExit(f"restart of {manifest['nprocs']} "
                                 f"processes, expected {mesh.nprocs}")
            # the reloaded global state's sums (another summation order)
            got = dict(zip(("aice", "vice", "u2", "e"),
                           _sums(loaded).tolist()))
            for k, v in sums.items():
                if abs(got[k] - v) > 1e-9 * max(abs(v), 1.0):
                    raise SystemExit(f"restart sum {k}: {got[k]} != {v}")
            print("RESTART_OK", flush=True)
        if dist.is_initialized():
            dist.barrier()
    print(f"DONE {rank}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
