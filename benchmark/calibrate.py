"""Read the numbers that decide `correct` over many seeds, and the
control's, to set a cell's limits.

    python3 benchmark/calibrate.py --workload gx1.analytic \
        --seeds 4000000001 4000000002 ... --controls 3 \
        --faults unchanged half [--also-bands N ...]

runs the cell once a seed, at the cell's own load, its window closed
once the step it compares is done (that step is drawn from the seed over
a window of BENCHMARK.json's `run_seconds`, as a run draws it), and on
the first `--controls` seeds also the control: the reference computed in
bfloat16 put in the program's place.  Each of `--faults` (``unchanged``,
``half``, ``alter``: see ``cell.Faulty``) is planted under the timed
path on the first seed.  A cell on one chip runs in this process, a cell
on several in one process a card (``harness/ranks.py``), as
``run.py`` runs it, its reference whole or in the bands of its
traffic's ``check.bands``.  Each of `--also-bands` computes the same
compared step's reference once more in that many full-width bands, and
the line gives each number's relative difference from the first
reference's, with each band's rows, time and memory.  The last line of standard output is one JSON object: per number, every
seed's reading, the largest (the lower reading of a limit), every
control reading and the smallest (the upper reading), each fault's
readings, and the bands' largest relative differences.  The benchmark's
own runs never make the control or plant a fault.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def run_one(workload: str, seed: int, seconds: float, chips: int, **kw):
    """One run's line, in this process or on `chips` ranks."""
    from harness import cell, ranks

    if chips == 1:
        return cell.run_cell(workload, seed, seconds, False, **kw)
    spec = {"name": workload, "seed": seed, "seconds": seconds,
            "trace": False, **kw}
    with tempfile.TemporaryFile("w+") as f:
        rc = ranks.launch(spec, chips, stdout=f)
        f.seek(0)
        lines = f.read().splitlines()
    if rc != 0 or not lines:
        raise RuntimeError(f"the ranks ended with exit code {rc}")
    return json.loads(lines[-1])


def band_agreement(out: dict) -> dict:
    """{bands: {number: relative difference from the first reference's}}."""
    agree = {}
    for n, b in out.get("band_checks", {}).items():
        agree[n] = {}
        for k, v in b["checks"].items():
            w = out["checks"][k]["value"]
            if isinstance(v, float) and isinstance(w, float):
                agree[n][k] = abs(v - w) / abs(w) if w else abs(v)
            else:
                agree[n][k] = math.inf if v != w else 0.0
    return agree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--also-bands", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    import torch

    from harness import cell

    chips = int(cell.cell_pieces(args.workload)[0]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA cards", file=sys.stderr)
        return 2
    cell.cache_dirs()
    seconds = float(cell.manifest()["run_seconds"])
    readings, controls, correct = {}, {}, []
    agreement = {}
    for i, seed in enumerate(args.seeds):
        out = run_one(args.workload, seed, seconds, chips,
                      control=i < args.controls, close_after_sample=True,
                      also_bands=args.also_bands)
        correct.append(out["correct"])
        for k, c in out["checks"].items():
            readings.setdefault(k, []).append(c["value"])
        for k, v in out.get("controls", {}).items():
            controls.setdefault(k, []).append(v)
        agree = band_agreement(out)
        for n, by in agree.items():
            agreement[n] = max([agreement.get(n, 0.0), *by.values()])
        print(json.dumps({"seed": seed, "checks": out["checks"],
                          "controls": out.get("controls"),
                          "reference": out.get("reference"),
                          "band_checks": out.get("band_checks"),
                          "band_agreement": agree}, default=str),
              flush=True)

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
    if agreement:
        summary["band_agreement"] = agreement
    summary["faults"] = {}
    for fault in args.faults:
        try:
            out = run_one(args.workload, args.seeds[0], seconds, chips,
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
