"""cice4_tpu_torch — the PyTorch/CUDA port of the cice4_tpu sea-ice model.

The package mirrors the layout of :mod:`cice4_tpu` module by module and
never imports JAX.  Plain tensor code is PyTorch; each Pallas kernel of
the JAX package becomes a CUDA kernel written for Hopper (``csrc/``),
built at first use by :mod:`cice4_tpu_torch.cuda_build`.

Importing the package imports no submodule, so that importing a leaf
module stays cheap; import what you need, e.g.::

    from cice4_tpu_torch.model import Model
"""
