"""ray_tpu_torch.serve.llm — LLM inference: continuous batching over a
paged KV cache, with GPT-2 or Llama in PyTorch behind it.

  engine.LLMEngine               per-replica continuous-batching scheduler
  kv_cache.PagedKVCache          refcounted block allocator
  prefix_cache.RadixPrefixCache  shared-prompt radix KV cache
  spec_decode                    toy / torch drafts + greedy verify
  model_runner                   ToyAdapter / TorchModelAdapter (gpt2, llama)
  deployment.LLMServer           the deployment callable
  disagg.KVShipper               prefill -> decode KV handoff (inline)

Typical use::

    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.serve.llm import LLMServer

    server = LLMServer("gpt2", {"config": GPT2Config.small()})
    print(server({"tokens": [464, 3290], "max_new_tokens": 16}))
    server.engine.stop()
"""

from ray_tpu_torch.serve.llm.deployment import ByteTokenizer, LLMServer
from ray_tpu_torch.serve.llm.disagg import KVShipError, KVShipper
from ray_tpu_torch.serve.llm.engine import (EngineConfig, LLMEngine,
                                            SamplingParams)
from ray_tpu_torch.serve.llm.kv_cache import OutOfKVBlocksError, PagedKVCache
from ray_tpu_torch.serve.llm.model_runner import (TorchModelAdapter,
                                                  ToyAdapter, make_adapter)
from ray_tpu_torch.serve.llm.prefix_cache import RadixPrefixCache
from ray_tpu_torch.serve.llm.spec_decode import (TorchDraft, ToyDraft,
                                                 greedy_verify, make_draft)

__all__ = [
    "LLMServer", "LLMEngine", "EngineConfig", "SamplingParams",
    "PagedKVCache", "OutOfKVBlocksError", "ToyAdapter",
    "TorchModelAdapter", "make_adapter", "ByteTokenizer",
    "RadixPrefixCache", "TorchDraft", "ToyDraft", "greedy_verify",
    "make_draft", "KVShipper", "KVShipError",
]
