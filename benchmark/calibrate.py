"""Read the numbers that decide `correct` over many seeds, and the
control's, to set a cell's limits.

    python3 benchmark/calibrate.py --workload gx1.analytic \
        --seeds 4000000001 4000000002 ... --controls 3 \
        --faults unchanged half

runs the cell once a seed in one process, at the cell's own load, its
window closed once the step it compares is done (that step is drawn from
the seed over a window of BENCHMARK.json's `run_seconds`, as a run
draws it), and on the first `--controls` seeds also the control: the
reference computed in bfloat16 put in the program's place.  Each of
`--faults` (``unchanged``, ``half``, ``alter``: see ``cell.Faulty``) is
planted under the timed path on the first seed.  The last line of
standard output is one JSON object: per number, every seed's reading,
the largest (the lower reading of a limit), every control reading and
the smallest (the upper reading), and each fault's readings.  The
benchmark's own runs never make the control or plant a fault.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", nargs="*", default=[])
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from harness import cell

    cell.cache_dirs()
    seconds = float(cell.manifest()["run_seconds"])
    readings, controls, correct = {}, {}, []
    for i, seed in enumerate(args.seeds):
        out = cell.run_cell(args.workload, seed, seconds, False,
                            control=i < args.controls,
                            close_after_sample=True)
        correct.append(out["correct"])
        for k, c in out["checks"].items():
            readings.setdefault(k, []).append(c["value"])
        for k, v in out.get("controls", {}).items():
            controls.setdefault(k, []).append(v)
        print(json.dumps({"seed": seed, "checks": out["checks"],
                          "controls": out.get("controls")}), flush=True)

    def num(v):
        return v if isinstance(v, float) else math.inf

    summary = {"workload": args.workload, "seeds": args.seeds,
               "correct": correct, "numbers": {}}
    for k, vals in readings.items():
        ctl = [v for v in controls.get(k, [])]
        summary["numbers"][k] = {
            "readings": vals, "lower": max(num(v) for v in vals),
            "controls": ctl,
            "upper": min((num(v) for v in ctl), default=None)}
    if "error" in controls:
        summary["control_errors"] = controls["error"]
    summary["faults"] = {}
    for fault in args.faults:
        try:
            out = cell.run_cell(args.workload, args.seeds[0], seconds, False,
                                fault=fault, close_after_sample=True)
        except (RuntimeError, ValueError, FloatingPointError) as e:
            # a fault that stops the program has failed the run
            summary["faults"][fault] = {"correct": False,
                                        "error": f"{type(e).__name__}: {e}"}
            continue
        summary["faults"][fault] = {
            "correct": out["correct"],
            "checks": {k: c["value"] for k, c in out["checks"].items()}}
        print(json.dumps({"fault": fault, **summary["faults"][fault]}),
              flush=True)
    print(json.dumps(summary, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
