"""Models of the port (counterparts of ``ray_tpu/models``)."""

from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config
from ray_tpu_torch.models.llama import (LlamaAttention, LlamaBlock,
                                        LlamaConfig, LlamaMLP, LlamaModel,
                                        RMSNorm, apply_rope, make_llama,
                                        rope_frequencies)
from ray_tpu_torch.models.resnet import (BottleneckResNetBlock, ResNet,
                                         ResNet18, ResNet34, ResNet50,
                                         ResNet101, ResNet152, ResNetBlock,
                                         create_resnet)

__all__ = ["BottleneckResNetBlock", "GPT2", "GPT2Config", "LlamaAttention",
           "LlamaBlock", "LlamaConfig", "LlamaMLP", "LlamaModel", "RMSNorm",
           "ResNet", "ResNet101", "ResNet152", "ResNet18", "ResNet34",
           "ResNet50", "ResNetBlock", "apply_rope", "create_resnet",
           "make_llama", "rope_frequencies"]
