"""Speculative decoding: a small draft proposes, the target verifies.

Greedy speculative decoding turns k sequential target decode steps
into one batched step without changing a single output token:

1. a cheap *draft* model proposes ``k`` greedy continuations,
2. the target runs ONE multi-token incremental step over
   ``[t_last, p_1 .. p_k]`` through the paged decode path
   (``adapter.decode_window``) — position ``j``'s logits condition on
   exactly the window prefix, because ``cached_attention`` is causal
   at the offset,
3. ``greedy_verify`` walks the target's argmaxes: a proposal is
   accepted while it equals what greedy decode *would* have emitted;
   the first mismatch is replaced by the target's own token
   (correction), and a fully accepted window yields one extra target
   token for free (bonus).

Acceptance therefore commits exactly the token sequence sequential
greedy decode produces — token-for-token identity is a theorem, not a
tuning goal; tests/test_torch_llm_engine.py asserts it for the toy
model.

Counterpart of ``ray_tpu/serve/llm/spec_decode.py``: ``greedy_verify``,
``ToyDraft`` and ``TorchDraft`` (``FlaxDraft`` there).

Drafts are *stateless* (no paged cache): the toy draft replays the
toy adapter's closed-form logits; a model draft runs one full forward
per proposed token.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch.serve.llm.model_runner import (_pad_pow2, build_model,
                                                  model_positions)


def greedy_verify(window: Sequence[int],
                  argmax_tokens: Sequence[int]) -> List[int]:
    """Accept/reject a speculative window.

    ``window`` is ``[t_last, p_1 .. p_{w-1}]`` (last committed token
    followed by draft proposals); ``argmax_tokens[j]`` is the target's
    greedy token after consuming ``window[:j+1]``.  Returns the tokens
    to commit: the accepted proposals, then either the target's
    correction at the first mismatch or — if every proposal matched —
    the bonus token after the full window.
    """
    committed: List[int] = []
    for j in range(len(window)):
        t = int(argmax_tokens[j])
        committed.append(t)
        if j + 1 < len(window) and int(window[j + 1]) != t:
            break
    return committed


class ToyDraft:
    """Greedy draft mirroring ``ToyAdapter``'s closed-form LM (next
    token = argmax(mean(embed[prefix]) @ E^T)) — cache-free, so it can
    draft for any toy target; seed it like the target for a
    high-acceptance draft or differently for an adversarial one."""

    def __init__(self, vocab_size: int = 256, dim: int = 32,
                 seed: int = 0):
        rng = np.random.RandomState(seed)
        self.vocab_size = int(vocab_size)
        self.embed = rng.randn(self.vocab_size, int(dim)).astype(
            np.float32)

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        toks = [int(t) % self.vocab_size for t in tokens]
        out: List[int] = []
        acc = self.embed[toks].sum(axis=0)
        for _ in range(int(k)):
            h = acc / len(toks)
            t = int(np.argmax(h @ self.embed.T))
            out.append(t)
            toks.append(t)
            acc = acc + self.embed[t]
        return out


class TorchDraft:
    """Greedy draft over a gpt2/llama model (the tiny test configs
    unless ``config`` is given; weights from flax ``params`` or seeded
    as the adapter seeds them, so a draft of the target's config and
    seed is the target): one full non-incremental forward per proposed
    token, its length padded to a power of two >= 8 and capped at the
    model's positions, and the LM head on the last real token only. No
    paged cache: speculation never touches the target's KV pool. Runs
    on ``cuda`` unless the caller asks for ``cpu``."""

    def __init__(self, kind: str = "gpt2", config=None, params=None,
                 seed: int = 0, device="cuda"):
        self.kind = kind
        self.cfg, self.model = build_model(kind, config, params, seed,
                                           device)
        self.device = next(self.model.parameters()).device
        self.vocab_size = self.cfg.vocab_size
        self.max_seq_len = model_positions(self.cfg)

    @torch.no_grad()
    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        toks = [int(t) for t in tokens]
        out: List[int] = []
        for _ in range(int(k)):
            n = len(toks)
            if n >= self.max_seq_len:
                break
            padded = np.zeros((1, min(_pad_pow2(n, 8), self.max_seq_len)),
                              np.int64)
            padded[0, :n] = toks
            # causal attention: positions < n never see the padding
            h = self.model.trunk(torch.from_numpy(padded).to(self.device))
            logits = self.model.head(h[:, n - 1]).float()
            t = int(logits[0].argmax())
            out.append(t)
            toks.append(t)
        return out


def make_draft(model: str = "toy",
               model_config: Optional[Dict[str, Any]] = None):
    """Engine-facing factory mirroring ``make_adapter``: ``model`` is
    ``toy`` | ``gpt2`` | ``llama`` (a model draft's ``device`` defaults
    to ``cuda``)."""
    model_config = dict(model_config or {})
    if model == "toy":
        return ToyDraft(**model_config)
    if model in ("gpt2", "llama"):
        return TorchDraft(kind=model, **model_config)
    raise ValueError(f"unknown draft model {model!r} (toy|gpt2|llama)")
