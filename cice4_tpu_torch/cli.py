"""Command-line interface: ``python -m cice4_tpu_torch run [config.toml]``
and ``python -m cice4_tpu_torch bench``.

Port of :mod:`cice4_tpu.cli`: a TOML file with sections matching the
Config dataclasses, named presets and dotted ``--set`` overrides, plus
``--device`` (default ``cuda``).  The run needs a CUDA device unless it
is given ``--device cpu``: without one it exits with status 2 and runs
nothing.  ``bench`` runs :mod:`cice4_tpu_torch.bench` (the configuration
of ``BENCH_CONFIG``) on the card; without one it exits with status 2 and
prints nothing on stdout.
"""

from __future__ import annotations

import argparse
import sys


def _load_config(args):
    from cice4_tpu_torch.config import (Config, col_config, config_from_dict,
                                        gx1_config, gx3_config)

    presets = {"gx3": gx3_config, "gx1": gx1_config, "col": col_config}
    cfg = presets[args.preset]() if args.preset else Config()
    if args.config:  # explicit config file overrides any preset
        import tomllib
        with open(args.config, "rb") as f:
            tree = tomllib.load(f)
        cfg = config_from_dict(tree)
    for kv in args.set or []:
        key, val = kv.split("=", 1)
        try:
            import ast
            val = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            pass
        cfg = cfg.with_values(**{key: val})
    return cfg


def main(argv=None):
    p = argparse.ArgumentParser(prog="cice4_tpu_torch",
                                description="sea-ice model, PyTorch/CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="run the model")
    runp.add_argument("config", nargs="?", help="TOML config file")
    runp.add_argument("--preset", choices=["gx3", "gx1", "col"],
                      default=None)
    runp.add_argument("--steps", type=int, default=None)
    runp.add_argument("--f64", action="store_true")
    runp.add_argument("--set", action="append", metavar="sec.key=val",
                      help="dotted config override, repeatable")
    runp.add_argument("--device", default="cuda",
                      help="torch device of the run (default cuda)")

    sub.add_parser("bench", help="run the benchmark (BENCH_CONFIG=gx1, "
                   "access025 or gx3) on the card")

    args = p.parse_args(argv)
    import torch

    device = torch.device("cuda" if args.cmd == "bench" else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("cice4_tpu_torch: no CUDA device; the port runs on the GPU"
              + ("" if args.cmd == "bench" else " unless given --device cpu"),
              file=sys.stderr)
        return 2
    if args.cmd == "bench":
        from cice4_tpu_torch.bench import main as bench_main
        return bench_main()

    from cice4_tpu_torch.driver import IceModelRun

    cfg = _load_config(args)
    dtype = torch.float64 if args.f64 else torch.float32
    run = IceModelRun(cfg, dtype=dtype, device=device)
    run.initialize()
    run.run(args.steps)
    run.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
