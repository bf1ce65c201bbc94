"""The port's counterpart of ``__graft_entry__.entry()``.

    fn, args = entry()          # on cuda; entry(device="cpu") for tests
    logits = fn(*args)          # [4, 512, 50257]

GPT-2 small (12 layers, 768 wide, 12 heads, bf16 compute, f32 params,
the flash backend) with random weights from seed 0, and a (4, 512)
batch of token ids: the forward goes through the whole-kv attention
kernel on the card, once per layer.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.device import resolve_device


def entry(device="cuda"):
    """(fn, args): the GPT-2-small forward and its example inputs."""
    from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config

    dev = resolve_device(device)
    cfg = GPT2Config(vocab_size=50257, n_positions=1024, n_embd=768,
                     n_layer=12, n_head=12, attention_backend="flash")
    model = GPT2(cfg).init_weights(torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    input_ids = torch.zeros((4, 512), dtype=torch.long, device=dev)

    def forward(model, input_ids):
        with torch.no_grad():
            return model(input_ids)

    return forward, (model, input_ids)
