"""Exact-restart checkpointing.

Port of the serial half of :mod:`cice4_tpu.io.restart`
(``source/ice_restart.F90`` `dumpfile:74-256`, `restartfile:265-578`):
the full prognostic state (category state, velocity, all 12 EVP stress
fields, `iceumask`, SST/frzmlt and the radiation scale factor) is written
so that a dump/resume run bit-matches a continuous run; a pointer file
chains restarts for `runtype = 'continue'`.

The file format is the JAX package's: one compressed ``.npz`` of the
state's fields (nested dicts flattened as ``"trcrn.iage"``) plus a JSON
header (format version, step index, model time, tracer names), so each
package reads the other's files.  The sharded pair of the JAX package
(`dump_restart_sharded`, `load_restart_sharded`) waits for the
multi-device port (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from cice4_tpu_torch.state import State

FORMAT_VERSION = 1


def _flatten(state: State) -> dict:
    """Flat {name: numpy array} view of the state, on the host."""
    flat = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, dict):
            for k, t in v.items():
                flat[f"{f.name}.{k}"] = t.detach().cpu().numpy()
        else:
            flat[f.name] = v.detach().cpu().numpy()
    return flat


def dump_restart(state: State, path: str, istep: int, time: float,
                 pointer_file: str | None = None, extra: dict | None = None):
    """Write a restart file (+ pointer file, ``ice_restart.F90:127-131``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = _flatten(state)
    header = dict(format=FORMAT_VERSION, istep=istep, time=time,
                  tracers=sorted(state.trcrn.keys()), **(extra or {}))
    np.savez_compressed(path, __header__=json.dumps(header), **flat)
    if pointer_file:
        os.makedirs(os.path.dirname(os.path.abspath(pointer_file)),
                    exist_ok=True)
        with open(pointer_file, "w") as f:
            f.write(os.path.abspath(path) + "\n")
    return path


def read_pointer(pointer_file: str) -> str:
    with open(pointer_file) as f:
        return f.read().strip()


def load_restart(path: str, template: State):
    """Read a restart into a State shaped like `template`: each field
    takes the template's dtype and device.

    Returns (state, header).  Mirrors `restartfile:265-578`; aggregates
    are recomputed by the caller's first step.
    """
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(str(z["__header__"]))
        flat = {k: z[k] for k in z.files if k != "__header__"}

    def like(src, t):
        return torch.as_tensor(np.ascontiguousarray(src)).to(
            device=t.device, dtype=t.dtype)

    kwargs = {}
    for f in dataclasses.fields(template):
        v = getattr(template, f.name)
        if isinstance(v, dict):
            kwargs[f.name] = {k: like(flat[f"{f.name}.{k}"], t)
                              for k, t in v.items()}
        else:
            kwargs[f.name] = like(flat[f.name], v)
    return State(**kwargs), header
