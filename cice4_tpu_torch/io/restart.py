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
package reads the other's files.

The sharded pair (`dump_restart_sharded`, `load_restart_sharded`) writes
and reads the JAX package's layout: each process writes its own blocks
to ``shards_p<proc>.npz`` (keys ``<name>__p<proc>_d<k>``, the k-th block
it owns) and ``manifest_p<proc>.json`` (each entry's global ``start`` and
``shape``), and process 0 writes ``manifest.json`` (the header and each
field's global shape and dtype, with ``nprocs``).  No process gathers
another's blocks; the loader puts every block back at its offset.
"""

from __future__ import annotations

import dataclasses
import glob
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

    return _from_flat(flat, template), header


def _from_flat(flat: dict, template: State) -> State:
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
    return State(**kwargs)


def dump_restart_sharded(blocks, mesh, directory: str, istep: int,
                         time: float, pointer_file: str | None = None):
    """Write the blocks of a decomposed state that this process owns
    (`blocks`: their States, in ``mesh.local_blocks`` order) in the JAX
    package's sharded layout (port of
    ``cice4_tpu/io/restart.py:107-165``)."""
    os.makedirs(directory, exist_ok=True)
    proc = mesh.rank
    flats = [_flatten(b) for b in blocks]
    shards, fields = {}, {}
    for name in flats[0]:
        entries = []
        for k, (b, flat) in enumerate(zip(mesh.local_blocks, flats)):
            arr = flat[name]
            key = f"{name}__p{proc}_d{k}"
            shards[key] = arr
            yi, xi = mesh.coords(b)
            by, bx = arr.shape[-2:]
            start = [0] * (arr.ndim - 2) + [yi * by, xi * bx]
            entries.append({"key": key, "start": start,
                            "shape": list(arr.shape)})
        arr = flats[0][name]
        gshape = list(arr.shape[:-2]) + [arr.shape[-2] * mesh.py,
                                         arr.shape[-1] * mesh.px]
        fields[name] = {"global_shape": gshape, "dtype": str(arr.dtype),
                        "shards": entries}
    manifest = {"format": FORMAT_VERSION, "istep": int(istep),
                "time": float(time), "nprocs": mesh.nprocs,
                "fields": fields}
    np.savez_compressed(os.path.join(directory, f"shards_p{proc}.npz"),
                        **shards)
    with open(os.path.join(directory, f"manifest_p{proc}.json"), "w") as fh:
        json.dump(manifest, fh)
    if proc == 0:
        header = {k: v for k, v in manifest.items() if k != "fields"}
        header["fields"] = {
            name: {k: v for k, v in info.items() if k != "shards"}
            for name, info in fields.items()}
        with open(os.path.join(directory, "manifest.json"), "w") as fh:
            json.dump(header, fh)
        if pointer_file:
            with open(pointer_file, "w") as fh:
                fh.write(directory + "\n")
    return directory


def load_restart_sharded(directory: str, template: State):
    """Reassemble a sharded dump of either package into a State shaped
    like the global `template` (each field takes the template's dtype and
    device): the manifests of every process, every block at its
    recorded offset (port of ``cice4_tpu/io/restart.py:168-225``).
    Returns (state, manifest)."""
    with open(os.path.join(directory, "manifest.json")) as fh:
        manifest = json.load(fh)
    per_proc = sorted(glob.glob(os.path.join(directory, "manifest_p*.json")))
    if len(per_proc) < int(manifest.get("nprocs", 1)):
        raise FileNotFoundError(
            f"found {len(per_proc)} per-process manifests, expected "
            f"{manifest.get('nprocs')}")
    merged = {name: dict(info, shards=[])
              for name, info in manifest["fields"].items()}
    for path in per_proc:
        with open(path) as fh:
            m = json.load(fh)
        for name, info in m["fields"].items():
            merged[name]["shards"].extend(info["shards"])
    manifest = dict(manifest, fields=merged)
    pieces = {}
    for path in sorted(glob.glob(os.path.join(directory, "shards_p*.npz"))):
        with np.load(path) as z:
            for k in z.files:
                pieces[k] = z[k]
    flat = {}
    for name, info in merged.items():
        out = np.zeros(info["global_shape"], dtype=info["dtype"])
        seen = np.zeros(info["global_shape"], dtype=bool)
        for e in info["shards"]:
            if e["key"] not in pieces:
                raise FileNotFoundError(
                    f"missing shard {e['key']} for field {name}")
            sl = tuple(slice(s0, s0 + n)
                       for s0, n in zip(e["start"], e["shape"]))
            out[sl] = pieces[e["key"]]
            seen[sl] = True
        if not seen.all():
            raise ValueError(f"incomplete shard coverage for {name}")
        flat[name] = out
    return _from_flat(flat, template), manifest
