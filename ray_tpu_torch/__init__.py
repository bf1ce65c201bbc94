"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu, slice by slice.

Beside the JAX package (``ray_tpu``, the reference), this package runs
the same system with PyTorch on an NVIDIA H100, with every TPU kernel
on a ported path rewritten by hand for Hopper (``kernels/csrc``). It
imports nothing of ``ray_tpu`` and nothing of JAX.

Ported so far: LLM serving of GPT-2 (``serve.llm``), with single-token
decode attention in a CUDA kernel. ROADMAP.md lists the slices to come.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
