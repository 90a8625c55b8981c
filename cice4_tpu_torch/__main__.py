"""``python -m cice4_tpu_torch run ...``: see :mod:`cice4_tpu_torch.cli`."""

import sys

from cice4_tpu_torch.cli import main

sys.exit(main())
