"""Run one cell of the port's benchmark on this machine's card and print
its result line.

    python3 benchmark/run.py --workload gx1.analytic --seed 7 \
        --seconds 30 --trace 0

from the root of a checkout.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; then ``checks``, each number
compared beside its limit, which also end standard error.  Without a
CUDA card the run exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# the benchmark's own packages, then the checkout's root for the program
sys.path[:0] = [str(HERE), str(HERE.parent)]

# top-level module names the program must not load (the JAX package it
# was ported from, and JAX itself)
FORBIDDEN = ("jax", "jaxlib", "flax", "cice4_tpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # one process with one host thread of compute: the program's host
    # work is its dispatch, and an idle pool of OpenMP threads only
    # competes with it for the cores (and spreads the runs' times)
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA card: the benchmark measures the port on a card and "
              "has no CPU fallback", file=sys.stderr)
        return 2

    from harness import cell

    cell.cache_dirs()
    out = cell.run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace))
    loaded = sorted({m.split(".", 1)[0] for m in sys.modules}
                    & set(FORBIDDEN))
    if loaded:
        print(f"forbidden modules loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
