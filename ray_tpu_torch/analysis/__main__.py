"""``python -m ray_tpu_torch.analysis`` — same surface as
``ray-tpu-torch lint``. The port's copy of
``ray_tpu/analysis/__main__.py``."""

import sys

from ray_tpu_torch.analysis.cli import main

sys.exit(main())
