"""Runoff regridding: masked, conserving gaussian filter.

Port of :mod:`cice4_tpu.ops.runoff_regrid` (the COSIMA coupled driver's
runoff smoother, ``drivers/access-om/gaussian_filter.F90``): river runoff
received on coastal points is spread over nearby ocean cells with a
gaussian kernel; weights clobbered by the land mask are redistributed
evenly over the unmasked part of each window so the field's total is
conserved (``convolve:69-135`` mask branch).

Each correlation is one ``torch.nn.functional.conv2d`` on an array padded
symmetrically (reflected including the edge, numpy's ``"symmetric"``
mode, which ``torch.nn.functional.pad`` lacks), as the JAX package's
``lax.conv_general_dilated`` on ``jnp.pad(..., mode="symmetric")``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel(sigma: float, truncate: float = 4.0):
    """(2r+1, 2r+1) normalized gaussian weights, r = int(truncate*sigma
    + 0.5), float64 on the CPU (``gaussian_kernel:10-39``; the factor 2 in
    the reference's unnormalized kernel cancels in the normalization)."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    k = np.exp(-0.5 * (xx**2 + yy**2) / sigma**2)
    return torch.from_numpy(k / k.sum())


def _symmetric_index(n: int, r: int, device):
    """Indices of a length-`n` axis padded by `r` on each side with
    numpy's "symmetric" mode: period 2n, the second half reversed."""
    i = torch.arange(-r, n + r, device=device) % (2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def _conv_same(a, kernel):
    """'Same'-size 2D correlation with symmetric (reflect-with-edge)
    padding: the boundary semantics of the reference's 3x3 flip tiling
    (one reflection per side)."""
    r = kernel.shape[0] // 2
    ny, nx = a.shape
    ap = a.index_select(0, _symmetric_index(ny, r, a.device)) \
        .index_select(1, _symmetric_index(nx, r, a.device))
    # no TF32: the filter is held to the CPU's result in f32 too
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = F.conv2d(ap[None, None].to(kernel.dtype), kernel[None, None])
    return out[0, 0]


def convolve(field, kernel, mask=None):
    """Gaussian-filtered field (``convolve:69-135``).

    mask: 1 on active cells, 0 on masked; masked cells pass through
    unchanged, and each window's masked weight is redistributed evenly
    over its unmasked cells so that a uniform field stays uniform and the
    filter conserves the masked-area integral."""
    kernel = kernel.to(device=field.device, dtype=field.dtype)
    if mask is None:
        return _conv_same(field, kernel)
    m = mask.to(device=field.device, dtype=field.dtype)
    ones = torch.ones_like(kernel)
    a = _conv_same(field * m, kernel)              # sum w * x * m
    clobber = _conv_same(1.0 - m, kernel)          # sum (1-m) * w
    count = torch.clamp(_conv_same(m, ones), min=1.0)  # sum m (unweighted)
    boxsum = _conv_same(field * m, ones)           # sum x * m
    out = a + clobber * boxsum / count
    return torch.where(m > 0.0, out, field)


def regrid_runoff(runof, tmask, sigma: float = 2.0):
    """Spread coastal runoff over nearby ocean with the masked gaussian
    filter (the driver applies this to the received runoff field before
    handing it to the ocean; `cpl_forcing_handler` runoff path)."""
    return convolve(runof, gaussian_kernel(sigma), tmask)
