"""How `correct` is decided: the program's results against the plain
reference's, field by field.

A gap of one field is the 2-norm of the program's field less the
reference's, over the norm of the reference's field, computed in float64.
Each number compared is the widest gap over a group of fields, and has
the limit of the cell's traffic file; a number that is not finite is not
within any limit.  The groups, one number each:

* ``start_gap``: the initial state, made by each side from the seed;
* ``ice_gap``: the ice state after the step, as the model conserves and
  transports it: area, volumes and enthalpies, and the surface
  temperature and each tracer times its parent (the category's area,
  ice volume or snow volume).  A tracer alone is undefined where a
  category holds ice of the size of a rounding error, and is reset there
  when the ice appears or goes: one such cell, which float32 and float64
  decide differently, moves the ice age's norm by a tenth;
* ``flow_gap``: the rest of the state but the stresses: velocities, the
  ice-ocean stress, the slab ocean, the shortwave scale;
* ``stress_gap``: the EVP's internal stresses, as means over blocks of
  8 x 8 cells.  The stresses of the last of 120 subcycles carry rounding
  from the masks and switches of the EVP into cell-sized patterns: the
  plain reference computed in float32 reads the program's 1-8% gap cell
  by cell, and two float64 computations of different order 1e-5 to 1e-3;
  the block means read a steady 0.2-2% there;
* ``export_gap`` (coupled): the exports to the ocean and atmosphere but
  the heat flux to the ocean;
* ``heat_gap`` (coupled): that heat flux as the ocean receives it in
  all: the flux (per unit of ice area) times the exported ice area,
  integrated over the cells' areas; the integrals' difference over the
  integral of its size.  Cell by cell it is not comparable: ridging
  makes it as sensitive as the stresses, and a cell of a thousandth of
  ice carries float32's rounding of its grid-box flux times a thousand;
* ``heat_block_gap`` (coupled): the same heat integrated over blocks of
  8 x 8 cells, the blocks' differences summed in size over the
  reference's blocks summed in size, so that heat moved from one region
  to another does not cancel as it does in the whole integral.
"""

from __future__ import annotations

import math
import sys

import torch


def flat(fields: dict, prefix: str = "") -> dict:
    """The floating-point tensors of a nested dict, by dotted name."""
    out = {}
    for k, v in fields.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor) and v.is_floating_point():
            out[f"{prefix}{k}"] = v
    return out


# a tracer's parent (ice_transport_driver.F90 trcr_depend: 0 area, 1 ice
# volume, 2 snow volume), by tracer name
PARENT = {0: "aicen", 1: "vicen", 2: "vsnon"}


def conserved(fields: dict) -> dict:
    """The state dict with the surface temperature and each tracer
    weighted by its parent (``tsfcn`` and ``trcrn.<name>`` replaced by
    ``aicen*tsfcn`` and ``<parent>*<name>``)."""
    from reference.ops.itd import TRACER_DEPEND

    def f64(v):
        return v.to(torch.float64)

    out = {k: v for k, v in fields.items() if k not in ("tsfcn", "trcrn")}
    out["aicen*tsfcn"] = f64(fields["aicen"]) * f64(fields["tsfcn"])
    for name, v in fields["trcrn"].items():
        parent = PARENT[TRACER_DEPEND[name]]
        out[f"{parent}*{name}"] = f64(fields[parent]) * f64(v)
    return out


def widest_few(g: dict, n: int = 4) -> str:
    """The `n` widest gaps, for the run's log."""
    top = sorted(g.items(), key=lambda kv: -kv[1] if math.isfinite(kv[1])
                 else -math.inf)[:n]
    return ", ".join(f"{k} {v:.3e}" for k, v in top)


def gaps(program: dict, reference: dict) -> dict:
    """{field: gap} over the reference's floating-point fields."""
    p, r = flat(program), flat(reference)
    out = {}
    for name, rv in r.items():
        pv = p[name].to(device=rv.device, dtype=torch.float64)
        rv = rv.to(torch.float64)
        num = float(torch.linalg.vector_norm(pv - rv))
        den = float(torch.linalg.vector_norm(rv))
        if den > 0.0:
            out[name] = num / den
        else:
            out[name] = 0.0 if num == 0.0 else math.inf
        if not math.isfinite(float(torch.linalg.vector_norm(pv))):
            out[name] = math.nan
    return out


def widest(g: dict) -> tuple[float, str]:
    """The widest gap and its field (a gap that is not a number counts
    as the widest)."""
    if not g:
        return 0.0, ""
    name = max(g, key=lambda k: math.inf if math.isnan(g[k]) else g[k])
    return g[name], name


def within(value: float, limit: float) -> bool:
    return math.isfinite(value) and value <= limit


def as_json_number(v: float):
    """A float as the result line can carry it: a string where it is not
    finite."""
    return v if math.isfinite(v) else str(v)


ICE = ("aicen", "vicen", "vsnon", "eicen", "esnon")
STRESS = ("stressp", "stressm", "stress12")
HEAT = "i2o.htflx_io"
ICE_AREA = "i2o.aice_io"


def block_mean(x, b: int = 8):
    """Means over b x b blocks of the last two axes (the rows and columns
    beyond the last whole block are left out)."""
    x = x.to(torch.float64)
    ny, nx = x.shape[-2] // b * b, x.shape[-1] // b * b
    y = x[..., :ny, :nx].reshape(*x.shape[:-2], ny // b, b, nx // b, b)
    return y.mean(dim=(-3, -1))


def size_gap(p, r) -> float:
    """The summed size of `p - r` over the summed size of `r`."""
    return float((p - r).abs().sum() / r.abs().sum())


def state_numbers(program: dict, reference: dict) -> dict:
    """{number: (gap, field)} of a state after a step or interval."""
    p, r = conserved(program), conserved(reference)
    ice = [k for k in r if k in ICE or "*" in k]
    flow = [k for k in r if k not in ice and k not in STRESS]
    return {
        "ice_gap": widest(gaps({k: p[k] for k in ice},
                               {k: r[k] for k in ice})),
        "flow_gap": widest(gaps({k: p[k] for k in flow},
                                {k: r[k] for k in flow})),
        "stress_gap": widest(gaps(
            {k: block_mean(p[k]) for k in STRESS},
            {k: block_mean(r[k]) for k in STRESS})),
    }


def export_numbers(program: dict, reference: dict, area) -> dict:
    """{number: (gap, field)} of a coupled interval's exports; `area` the
    cells' areas (the reference's grid)."""
    p, r = flat(program), flat(reference)
    g = gaps({k: v for k, v in p.items() if k != HEAT},
             {k: v for k, v in r.items() if k != HEAT})
    a = area.to(torch.float64)
    ph = (p[HEAT] * p[ICE_AREA]).to(device=a.device, dtype=torch.float64) * a
    rh = (r[HEAT] * r[ICE_AREA]).to(torch.float64) * a
    heat = float((ph - rh).sum().abs() / rh.abs().sum())
    block = size_gap(block_mean(ph), block_mean(rh))
    if not math.isfinite(float(ph.sum())):
        heat = block = math.nan
    print(f"heat flux times ice area, cell by cell: {size_gap(ph, rh):.6e}",
          file=sys.stderr, flush=True)
    return {"export_gap": widest(g), "heat_gap": (heat, HEAT),
            "heat_block_gap": (block, HEAT)}
