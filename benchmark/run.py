"""Run one cell of the port's benchmark on this machine's card and print
its result line.

    python3 benchmark/run.py --workload gx1.analytic --seed 7 \
        --seconds 30 --trace 0

from the root of a checkout.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; then ``checks``, each number
compared beside its limit, which also end standard error.  Without a
CUDA card, or with fewer cards than the cell's ``chips``, the run exits
with code 2 and prints no result.  A cell on several chips runs one
process a card (``harness/ranks.py``); this process prints the result
once every rank has ended well.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# the benchmark's own packages, then the checkout's root for the program
sys.path[:0] = [str(HERE), str(HERE.parent)]


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

    chips = int(cell.cell_pieces(args.workload)[0]["chips"])
    if torch.cuda.device_count() < chips:
        print(f"cell {args.workload} asks for {chips} cards and this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    cell.cache_dirs()
    if chips > 1:
        from harness import ranks

        return ranks.launch({"name": args.workload, "seed": args.seed,
                             "seconds": args.seconds,
                             "trace": bool(args.trace)}, chips)
    out = cell.run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace))
    return cell.emit(out, cell.forbidden_loaded())


if __name__ == "__main__":
    sys.exit(main())
