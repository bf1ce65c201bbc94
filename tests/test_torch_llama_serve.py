"""The port's Llama serving path against the JAX package's, on the CPU.

``LlamaConfig.tiny()`` (2 layers, 8 heads over 2 kv heads, f32) with
the same numpy-seeded params on both sides (``params_from_flax``): the
incremental forward over a contiguous cache (logits and caches within
1e-4, as ``test_torch_gpt2.py`` holds GPT-2's), the adapter under the
engine against ``FlaxModelAdapter("llama")`` (greedy tokens identical,
with and without the prefix cache), the model drafts' proposals against
``FlaxDraft``'s, a Llama target with a GPT-2 draft against plain greedy
decode, and the KV export/import round trip.
"""

import dataclasses
import functools
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt2 as JG
from ray_tpu.models import llama as JL
from ray_tpu.serve.llm import EngineConfig as JEngineConfig
from ray_tpu.serve.llm import FlaxModelAdapter
from ray_tpu.serve.llm import LLMEngine as JLLMEngine
from ray_tpu.serve.llm import SamplingParams as JSamplingParams
from ray_tpu.serve.llm.spec_decode import FlaxDraft
from ray_tpu_torch.models import llama as TL
from ray_tpu_torch.serve.llm import (EngineConfig, LLMEngine, LLMServer,
                                     PagedKVCache, SamplingParams,
                                     TorchDraft, TorchModelAdapter,
                                     make_adapter, make_draft)

TOL = dict(rtol=1e-4, atol=1e-4)
VOCAB = 512                     # both tiny configs


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Keep PyTorch to 2 intra-op threads while this file runs: the
    suite runs in parallel workers beside timing-sensitive tests."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@functools.lru_cache(maxsize=None)
def _params(kind):
    """The tiny model's params in flax's tree, made once from a seed
    with numpy: Dense kernels and embeddings normal with std
    fan_in^-0.5 (an embedding's: its width), biases 0.1 * normal, norm
    weights and scales 1 + 0.1 * normal. The tree's shape comes from
    ``jax.eval_shape`` of flax's init (no compile)."""
    model = (JL.LlamaModel(JL.LlamaConfig.tiny()) if kind == "llama"
             else JG.GPT2(JG.GPT2Config.tiny()))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    rng = np.random.RandomState(0 if kind == "llama" else 1)

    def fill(path, leaf):
        x = rng.randn(*leaf.shape).astype(np.float32)
        name = path[-1].key
        if name in ("weight", "scale"):
            return jnp.asarray(1 + 0.1 * x)
        if name == "bias":
            return jnp.asarray(0.1 * x)
        fan_in = leaf.shape[0] if name == "kernel" else leaf.shape[1]
        return jnp.asarray(x * fan_in ** -0.5)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _drain_stream(eng, sid, timeout=60.0):
    toks, cur = [], 0
    deadline = time.time() + timeout
    while time.time() < deadline:
        ch = eng.poll(sid, cur, max_wait_s=5.0)
        toks += ch["tokens"]
        cur = ch["cursor"]
        if ch["done"]:
            assert not ch.get("error"), ch
            return toks, ch
    raise TimeoutError("stream did not finish")


# ------------------------------------------- (a) the incremental forward


def test_incremental_forward_matches_jax():
    """A ragged prefill (right-padded, ``valid``) over a contiguous
    cache, then 3 single-token steps in which one row at a time sits out
    (``valid`` False): logits at the real tokens and every cache slot
    within 1e-4 of JAX's ``LlamaModel.apply(kv_cache=...)``."""
    params = _params("llama")
    mj = JL.LlamaModel(JL.LlamaConfig.tiny())
    cfg = TL.LlamaConfig.tiny()
    mt = TL.LlamaModel(cfg).eval()
    TL.params_from_flax(params, mt)
    B, S, S_max = 3, 8, 16
    rng = np.random.RandomState(2)
    n = np.array([8, 5, 3])
    steps = [(rng.randint(0, VOCAB, (B, S)), np.arange(S)[None] < n[:, None])]
    for skip in range(3):
        steps.append((rng.randint(0, VOCAB, (B, 1)),
                      (np.arange(B) != skip)[:, None]))
    cj = JL.init_kv_cache(JL.LlamaConfig.tiny(), B, S_max)
    ct = TL.init_kv_cache(cfg, B, S_max, device="cpu")
    assert ct[0]["k"].shape == (B, S_max, cfg.n_kv_heads, cfg.head_dim)
    lens = np.zeros(B, np.int32)
    for ids, valid in steps:
        lj, cj = mj.apply(params, jnp.asarray(ids, jnp.int32), kv_cache=cj,
                          seq_lengths=jnp.asarray(lens),
                          valid=jnp.asarray(valid))
        with torch.no_grad():
            lt, ct = mt(torch.from_numpy(ids), kv_cache=ct,
                        seq_lengths=torch.from_numpy(lens),
                        valid=torch.from_numpy(valid))
        assert lt.dtype == torch.float32
        np.testing.assert_allclose(lt.numpy()[valid], np.asarray(lj)[valid],
                                   **TOL)
        for layer_t, layer_j in zip(ct, cj):
            for kv in ("k", "v"):
                np.testing.assert_allclose(layer_t[kv].numpy(),
                                           np.asarray(layer_j[kv]), **TOL)
        lens = lens + valid.sum(1).astype(np.int32)


def test_trunk_head_is_the_training_forward():
    """``forward(ids)`` without a cache is ``head(trunk(ids))`` and the
    JAX full forward, and ``to_compute_dtype`` stores the blocks and the
    embedding in ``cfg.dtype`` while the head and the norms stay f32."""
    params = _params("llama")
    cfg = TL.LlamaConfig.tiny()
    mt = TL.LlamaModel(cfg)
    TL.params_from_flax(params, mt)
    ids = np.random.RandomState(3).randint(0, VOCAB, (2, 12))
    with torch.no_grad():
        full = mt(torch.from_numpy(ids))
        np.testing.assert_array_equal(
            mt.head(mt.trunk(torch.from_numpy(ids))).numpy(), full.numpy())
    np.testing.assert_allclose(
        full.numpy(), np.asarray(JL.LlamaModel(JL.LlamaConfig.tiny()).apply(
            params, jnp.asarray(ids, jnp.int32))), **TOL)
    half = TL.LlamaModel(dataclasses.replace(cfg, dtype=torch.bfloat16))
    half.to_compute_dtype()
    assert half.tok_embeddings.weight.dtype == torch.bfloat16
    assert half.layers_1.feed_forward.w2.weight.dtype == torch.bfloat16
    assert half.output.weight.dtype == torch.float32
    assert half.norm.weight.dtype == torch.float32
    assert half.layers_0.attention_norm.weight.dtype == torch.float32


# ------------------------------------------ (b) the adapter under LLMEngine


@pytest.fixture(scope="module")
def flax_llama():
    # one adapter for every engine below: its jitted steps are cached
    # per (batch, length) bucket
    return FlaxModelAdapter("llama", params=_params("llama"))


# 4 requests of mixed prompt lengths; the last three share the first's
# 20-token prefix, so with the prefix cache they hit after it finishes
_PREFIX = [int(t) for t in np.random.RandomState(6).randint(0, VOCAB, 20)]
_REQUESTS = [(_PREFIX + [1, 2, 3], 6), (_PREFIX + [7], 5),
             (_PREFIX[:11], 7), (_PREFIX + [4] * 9, 4)]


def _generate(engine_cls, cfg_cls, sp_cls, adapter, prefix_cache):
    eng = engine_cls(adapter, cfg_cls(
        max_running=4, num_blocks=48, block_size=8, max_seq_len=64,
        enable_prefix_cache=prefix_cache))
    try:
        (p0, n0), rest = _REQUESTS[0], _REQUESTS[1:]
        first = [_drain_stream(eng, eng.add_request(
            list(p0), sp_cls(max_new_tokens=n0)))[0]]
        sids = [eng.add_request(list(p), sp_cls(max_new_tokens=n))
                for p, n in rest]
        outs = first + [_drain_stream(eng, s)[0] for s in sids]
        return outs, eng.metrics()
    finally:
        eng.stop()


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_llama_adapter_matches_flax_adapter(flax_llama, prefix_cache):
    ref, _ = _generate(JLLMEngine, JEngineConfig, JSamplingParams,
                       flax_llama, prefix_cache)
    port = TorchModelAdapter("llama", params=_params("llama"), device="cpu")
    assert (port.n_kv_heads, port.head_dim, port.max_seq_len) == (2, 16, 256)
    got, m = _generate(LLMEngine, EngineConfig, SamplingParams, port,
                       prefix_cache)
    assert got == ref
    assert [len(t) for t in got] == [n for _, n in _REQUESTS]
    assert port.decode_steps > 0
    assert port.k_pages.shape[-2:] == (2, 16)      # Hkv heads, not H
    if prefix_cache:
        assert m["cache_hit_tokens_total"] > 0


def test_llama_server_caps_max_seq_len_and_answers():
    server = LLMServer(model="llama", model_config={
        "params": _params("llama"), "device": "cpu"},
        engine_config={"num_blocks": 32, "block_size": 8,
                       "max_seq_len": 4096})
    try:
        assert server.engine.config.max_seq_len == 256
        out = server({"tokens": [5, 6, 7], "max_new_tokens": 4})
        assert out["n_tokens"] == 4 and out["finish_reason"] == "length"
        with pytest.raises(ValueError, match="token ids"):
            server({"tokens": [VOCAB]})
    finally:
        server.__serve_prepare_shutdown__()


# --------------------------------------------------------- (c) the drafts


@pytest.mark.parametrize("kind", ["gpt2", "llama"])
def test_torch_draft_proposes_as_flax_draft(kind):
    """Greedy proposals from prompts whose padded length crosses the
    8 -> 16 bucket while drafting: the same tokens on both sides."""
    params = _params(kind)
    ref = FlaxDraft(kind, params=params)
    port = TorchDraft(kind, params=params, device="cpu")
    assert port.vocab_size == VOCAB
    rng = np.random.RandomState(7)
    for n in (3, 6):
        tokens = [int(t) for t in rng.randint(0, VOCAB, n)]
        assert port.propose(tokens, 5) == ref.propose(tokens, 5)


def test_draft_stops_at_the_model_positions():
    port = TorchDraft("llama", params=_params("llama"), device="cpu")
    assert port.propose([1] * 254, 5) == port.propose([1] * 254, 2)
    assert len(port.propose([1] * 254, 5)) == 2
    assert port.propose([1] * 256, 3) == []


def test_spec_decode_llama_with_gpt2_draft_identity():
    """A GPT-2 tiny draft drafts for a Llama tiny target (both 512-token
    vocabs); its proposals are mostly wrong, and the verified windows
    still commit exactly plain greedy decode's tokens."""
    rng = np.random.RandomState(19)
    prompts = [[int(t) for t in rng.randint(0, VOCAB, n)] for n in (6, 13)]

    def run(spec_k):
        eng = LLMEngine(
            make_adapter("llama", {"params": _params("llama"),
                                   "device": "cpu"}),
            EngineConfig(num_blocks=64, block_size=8, max_seq_len=128,
                         max_running=4, spec_k=spec_k, draft_model="gpt2",
                         draft_model_config={"params": _params("gpt2"),
                                             "device": "cpu"}))
        try:
            sids = [eng.add_request(p, SamplingParams(max_new_tokens=6))
                    for p in prompts]
            return [_drain_stream(eng, s)[0] for s in sids], eng.metrics()
        finally:
            eng.stop()

    plain, _ = run(0)
    spec, m = run(2)
    assert spec == plain
    assert m["spec_draft_tokens_total"] > 0


def test_spec_decode_llama_self_draft_accepts_every_proposal():
    """A draft of the target's own params proposes what greedy decode
    would emit: every proposal is accepted and the tokens are plain
    greedy's."""
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5, 8, 9, 7]]
    cfg = {"params": _params("llama"), "device": "cpu"}

    def run(spec_k):
        eng = LLMEngine(make_adapter("llama", cfg), EngineConfig(
            num_blocks=64, block_size=8, max_seq_len=128, spec_k=spec_k,
            draft_model="llama", draft_model_config=cfg))
        try:
            sids = [eng.add_request(p, SamplingParams(max_new_tokens=9))
                    for p in prompts]
            return [_drain_stream(eng, s)[0] for s in sids], eng.metrics()
        finally:
            eng.stop()

    plain, _ = run(0)
    spec, m = run(3)
    assert spec == plain
    assert m["spec_draft_tokens_total"] > 0
    assert m["spec_accepted_tokens_total"] == m["spec_draft_tokens_total"]


# ------------------------------------------------ (d) export / import


class _Seq:
    def __init__(self, seq_id, prompt):
        self.seq_id, self.prompt, self.tokens = seq_id, prompt, []


def test_llama_export_import_roundtrip():
    src, dst = (TorchModelAdapter("llama", params=_params("llama"),
                                  device="cpu") for _ in range(2))
    for a in (src, dst):
        a.bind_cache(PagedKVCache(num_blocks=16, block_size=8))
    prompt = list(range(1, 13))
    src.cache.allocate("s", 20)
    dst.cache.allocate("filler", 8)      # different physical pages
    dst.cache.allocate("d", 20)
    logits = src.prefill([_Seq("s", prompt)])
    blob = src.export_kv("s", len(prompt))
    assert blob["kind"] == "torch:llama"
    assert blob["k"].shape == (2, 2, 8, 2, 16)     # [L, pages, bs, Hkv, D]
    dst.import_kv("d", len(prompt), blob)
    nxt = int(logits[0].argmax())
    seq_s, seq_d = _Seq("s", prompt), _Seq("d", prompt)
    seq_s.tokens = seq_d.tokens = [nxt]
    np.testing.assert_array_equal(src.decode([seq_s]), dst.decode([seq_d]))
    with pytest.raises(ValueError, match="torch:llama"):
        dst.import_kv("d", len(prompt), {**blob, "kind": "torch:gpt2"})


def test_llama_adapter_refuses_rows_past_its_positions():
    """A row that would pass the model's 256 positions (the RoPE table's
    rows) is refused on the host, before any model call."""
    a = TorchModelAdapter("llama", params=_params("llama"), device="cpu")
    a.bind_cache(PagedKVCache(num_blocks=40, block_size=8))
    a.cache.allocate("s", 257)
    with pytest.raises(ValueError, match="256 positions"):
        a.prefill([_Seq("s", [1] * 257)])


# ---------------------------------------------------- (e) the device rule


def test_llama_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: this checks the CPU-only refusal")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_adapter("llama")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_draft("llama")
