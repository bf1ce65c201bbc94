"""What each kernel uses on the card, from the build of this checkout:

    python3 -m ray_tpu_torch.kernels

Builds every source in ``csrc/`` (``nvcc``, so on a machine with the
CUDA toolkit) and prints one JSON line per kernel instance: registers
per thread at launch, stack and spill bytes (``-Xptxas -v``), and for
the attention and paged-decode kernels the dynamic shared memory per
CTA that their launch sets.
"""

import json

from ray_tpu_torch import kernels
from ray_tpu_torch.ops import attention


def main():
    for name in kernels.sources():
        rows = (attention.attention_resource_usage(name)
                if name in ("flash_attention", "whole_attention")
                else attention.paged_resource_usage()
                if name == "paged_decode"
                else kernels.resource_usage(name))
        for r in rows:
            print(json.dumps({"source": name + ".cu", **r}))


if __name__ == "__main__":
    main()
