"""Time the EVP round kernel's tiles at gx1's rounds on 2x2 blocks.

    python tools/time_round_tiles.py [--steps N]

On the card: the decomposed gx1 path of ``chip_smoke.py`` (o), one step
after ``--steps`` (default 1), every round kernel call of that step
captured (48: 12 rounds of 4 padded 214x182 blocks); then, for each core
tile and most subcycles a launch in TILES, the first round's device time
and the 48 rounds' together (CUDA events, ``chip_smoke.device_ms``),
each tile held bit for bit against the plain version at the first round,
in the order of TILES and then reversed.  Prints the card's name and
power limit.  Settles `evp_cuda.ROUND_TILE` (PERF.md section 6).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from cice4_tpu_torch.ops import evp as evp_ops  # noqa: E402
from cice4_tpu_torch.ops import evp_cuda  # noqa: E402

# (core rows, core columns, most subcycles a launch): 8 x 16, the wrapper's
# f32 tile, beside larger and smaller cores and rounds split in two
TILES = ((8, 16, 10), (16, 16, 10), (16, 8, 10), (12, 16, 10), (8, 8, 10),
         (8, 16, 5), (16, 16, 5), (16, 32, 5))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_round_tiles: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(f"card: {cs.card_line()}", flush=True)
    cfg = cs.make_config(cs.MAIN)
    model, state, forcing = cs.make_run(cfg, device, torch.float32)
    mesh, models, states = cs.decompose(model, state, cs.DECOMP_MESH)
    states, _ = cs.block_steps(models, states, forcing, mesh, 0, args.steps)
    real, calls = evp_cuda.evp_rounds, []

    def record(*a):
        calls.append(a)
        return real(*a)

    record.launches = 0
    evp_cuda.evp_rounds = record
    try:
        cs.block_steps(models, states, forcing, mesh, args.steps, 1)
    finally:
        evp_cuda.evp_rounds = real
    first = calls[0]
    want = evp_ops._evp_rounds_plain(*first)
    print(f"{len(calls)} round calls in step {args.steps + 1}; the first on "
          f"{tuple(first[14].shape)} with {int(first[3].sum())} icy T cells",
          flush=True)
    for tile in TILES + TILES[::-1]:
        rows, cols, most = tile
        launches = evp_cuda.round_launches(first[0].ndte, most)

        def round_(a, rows=rows, cols=cols, launches=launches):
            p, *const = a[:14]
            state = a[14:]
            for k in launches:
                state = evp_cuda.round_launch(p, *const, *state, rows, cols,
                                              k)
            return state

        got = round_(first)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        one = cs.device_ms(lambda f=round_: f(first), 30)

        def step(f=round_):
            for a in calls:
                f(a)

        print(f"tile {tile} launches {launches}: "
              f"first round {one:.4f} ms, the {len(calls)} rounds "
              f"{cs.device_ms(step, 5):.4f} ms (device time); bit-equal to "
              f"the plain version {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
