"""Models of the port (counterparts of ``ray_tpu/models``)."""

from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config
from ray_tpu_torch.models.llama import (LlamaAttention, LlamaBlock,
                                        LlamaConfig, LlamaMLP, LlamaModel,
                                        RMSNorm, apply_rope, make_llama,
                                        rope_frequencies)

__all__ = ["GPT2", "GPT2Config", "LlamaAttention", "LlamaBlock",
           "LlamaConfig", "LlamaMLP", "LlamaModel", "RMSNorm", "apply_rope",
           "make_llama", "rope_frequencies"]
