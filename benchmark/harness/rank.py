"""One rank of a run on several cards, as ``harness.ranks.launch`` starts
it: ``python3 benchmark/harness/rank.py '<spec>'``, the spec a JSON
object of ``cell.run_cell``'s arguments (``device`` ``cuda``, the
default, puts rank r on card r).  Rank 0 prints the run's result as
``run.py`` does; the other ranks print nothing on standard output.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# the benchmark's own packages, then the checkout's root for the program
sys.path[:0] = [str(HERE.parent), str(HERE.parent.parent)]


def main(argv=None) -> int:
    spec = json.loads((argv or sys.argv[1:])[0])
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    import torch

    torch.set_num_threads(1)
    from harness import cell, ranks

    cell.cache_dirs()
    device = torch.device(spec.pop("device", "cuda"))
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if spec.get("dtype"):
        spec["dtype"] = cell.DTYPES[spec["dtype"]]
    if spec.get("root"):
        spec["root"] = Path(spec["root"])
    group = ranks.Ranks(device)
    try:
        out = cell.run_cell(**spec, device=device, group=group)
        loaded = group.gather(cell.forbidden_loaded())
    finally:
        group.close()
    if group.rank != 0:
        return 0
    return cell.emit(out, sorted(set().union(*map(set, loaded))))


if __name__ == "__main__":
    sys.exit(main())
