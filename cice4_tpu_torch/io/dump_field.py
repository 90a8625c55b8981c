"""Per-field time-series debug dumps.

Port of :mod:`cice4_tpu.io.dump_field` (COSIMA's ``source/dump_field.F90``
and the `-DUNIT_TESTING` golden-field instrumentation of
``bld/build.sh:27-31`` / ``cpl_interface.F90:468-472``): appends named 2D
fields to ``.npz`` shards (``field`` and a JSON ``__meta__`` with
min/max/mean), the same files as the JAX package writes, so that
:meth:`FieldDumper.compare` reads dumps of either package.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


class FieldDumper:
    def __init__(self, directory: str = "./dumps", enabled: bool = True):
        self.dir = directory
        self.enabled = enabled
        self._count: dict[str, int] = {}

    def dump(self, name: str, field, istep: int | None = None):
        """Write one snapshot of `field` (a tensor on any device, or an
        array) with summary stats."""
        if not self.enabled:
            return None
        os.makedirs(self.dir, exist_ok=True)
        arr = field.detach().cpu().numpy() if isinstance(field, torch.Tensor) \
            else np.asarray(field)
        k = self._count.get(name, 0)
        self._count[name] = k + 1
        tag = istep if istep is not None else k
        path = os.path.join(self.dir, f"{name}.{tag:06d}.npz")
        stats = dict(min=float(arr.min()), max=float(arr.max()),
                     mean=float(arr.mean()))
        np.savez_compressed(path, field=arr,
                            __meta__=json.dumps(dict(name=name, step=tag,
                                                     **stats)))
        return path

    @staticmethod
    def compare(path_a: str, path_b: str, rtol=1e-6, atol=1e-9):
        """Golden-file comparison of two dumps."""
        with np.load(path_a) as za, np.load(path_b) as zb:
            a, b = za["field"], zb["field"]
        ok = np.allclose(a, b, rtol=rtol, atol=atol)
        maxdiff = float(np.abs(a - b).max()) if a.shape == b.shape else None
        return ok, maxdiff
