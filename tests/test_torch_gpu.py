"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Marked `gpu` and skipped without a CUDA device.  The file imports
no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances are those of `cice4_tpu_torch.kernel_check`.
"""

import pytest
import torch

from cice4_tpu_torch import kernel_check
from cice4_tpu_torch.config import gx1_config
from cice4_tpu_torch.ops import therm_vertical as tv
from cice4_tpu_torch.state import make_itd_params


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the therm_newton kernel runs only "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(5, 64, 128), (5, 116, 100), (1, 7, 33)])
def test_therm_newton_matches_plain(cuda_device, dtype, shape):
    cfg = gx1_config()
    p = tv.make_thermo_params(cfg, make_itd_params(cfg))
    args = kernel_check.make_inputs(p, *shape, seed=7, device=cuda_device,
                                    dtype=dtype)
    before = tv.temperature_changes.launches
    kern = tv.temperature_changes(p, 3600.0, *args)
    assert tv.temperature_changes.launches == before + 1
    plain = tv._temperature_changes_core(p, 3600.0, *args)
    torch.cuda.synchronize()
    report = kernel_check.compare(kern, plain, args[0], dtype)
    assert report["ok"], report


@pytest.mark.gpu
def test_therm_newton_on_a_plane_and_rejects_bad_input(cuda_device):
    """A (ny, nx) call (no category axis) equals category 0 of a batched
    call; a wrong dtype or layer count raises."""
    cfg = gx1_config()
    p = tv.make_thermo_params(cfg, make_itd_params(cfg))
    args = kernel_check.make_inputs(p, 2, 40, 24, seed=3,
                                    device=cuda_device, dtype=torch.float64)
    both = tv.temperature_changes(p, 3600.0, *args)
    one = tv.temperature_changes(
        p, 3600.0, *(a[0] if a.dim() >= 3 and a.shape[0] == 2 else a
                     for a in args))
    for k in kernel_check.FIELDS:
        torch.testing.assert_close(one[k], both[k][0], rtol=0, atol=0)
    with pytest.raises(TypeError):
        tv.temperature_changes(p, 3600.0, args[0],
                               *(a.to(torch.float16) for a in args[1:]))
    p2 = tv.ThermoParams(**{**vars(p), "nilyr": 3})
    with pytest.raises(NotImplementedError):
        tv.temperature_changes(p2, 3600.0, *args)
