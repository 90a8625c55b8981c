"""The benchmark's plain reference of one model step and one coupled
interval.

A frozen copy of the plain PyTorch path of the port as it stood when the
benchmark was defined: the same equations, every one of them eager
PyTorch, with no hand-written kernel, no block decomposition and no
import of the port.  Where the port launches a kernel this copy runs the
kernel's plain version (the masked Newton loop, the Python loop of EVP
subcycles, the GSH geometry and the reconstruction-contraction of the
remap).  It builds its own grid, forcing, calendar and coupler boundary
from the benchmark's inputs.  :mod:`reference.step` is its entry.

It holds the options that the benchmark's cells run and refuses the
others (:func:`reference.model._check_supported`, the ``om`` exchange of
:meth:`reference.step.Reference.interval`, the ``ncar`` and analytic
forcing of :func:`reference.forcing_data.make_forcing_provider`): a cell
that needs another option brings that branch with it.
"""
