"""The port's LLM engine and server, on the CPU.

The copied engine keeps the JAX package's scheduling properties with
the toy model, and ``TorchModelAdapter`` (GPT-2 tiny, f32, params
carried across from flax) gives the same greedy tokens as
``FlaxModelAdapter`` through ``LLMEngine``, with and without the
prefix cache.
"""

import time

import numpy as np
import pytest
import torch

from ray_tpu.serve.llm import EngineConfig as JEngineConfig
from ray_tpu.serve.llm import FlaxModelAdapter
from ray_tpu.serve.llm import LLMEngine as JLLMEngine
from ray_tpu.serve.llm import SamplingParams as JSamplingParams
from ray_tpu_torch.models.gpt2 import GPT2Config
from ray_tpu_torch.serve.exceptions import ReplicaOverloadedError
from ray_tpu_torch.serve.llm import (EngineConfig, LLMEngine, LLMServer,
                                     PagedKVCache, SamplingParams,
                                     TorchModelAdapter, ToyAdapter,
                                     greedy_verify, make_adapter,
                                     make_draft)
from ray_tpu_torch.serve.llm.kv_cache import OutOfKVBlocksError


def _drain_stream(eng, sid, timeout=60.0):
    toks, cur = [], 0
    deadline = time.time() + timeout
    while time.time() < deadline:
        ch = eng.poll(sid, cur, max_wait_s=5.0)
        toks += ch["tokens"]
        cur = ch["cursor"]
        if ch["done"]:
            return toks, ch
    raise TimeoutError("stream did not finish")


# ---------------------------------------------------------- toy engine


def test_continuous_vs_static_batching_same_tokens():
    rng = np.random.RandomState(0)
    reqs = [(list(rng.randint(0, 256, rng.randint(3, 12))),
             int(rng.randint(2, 10))) for _ in range(9)]

    def run(policy):
        eng = LLMEngine(ToyAdapter(seed=3), EngineConfig(
            max_running=4, num_blocks=64, block_size=8,
            max_seq_len=128, policy=policy))
        try:
            sids = [eng.add_request(p, SamplingParams(max_new_tokens=n))
                    for p, n in reqs]
            return [_drain_stream(eng, sid)[0] for sid in sids]
        finally:
            eng.stop()

    assert run("continuous") == run("static")


def test_paged_kv_allocator_exact_admission():
    c = PagedKVCache(num_blocks=8, block_size=4)   # 7 usable pages
    assert c.blocks_for(9) == 3
    t1 = c.allocate("a", 9)
    assert 0 not in t1                             # null page reserved
    assert c.can_allocate(16) and not c.can_allocate(17)
    with pytest.raises(OutOfKVBlocksError):
        c.allocate("b", 17)
    assert c.free("a") == 3 and c.occupancy() == 0.0
    assert c.free("a") == 0


def test_kv_exhaustion_queues_instead_of_oom():
    # 15 usable pages of 4 tokens; each request needs 8 pages
    eng = LLMEngine(ToyAdapter(), EngineConfig(
        max_running=8, num_blocks=16, block_size=4, max_seq_len=64))
    try:
        a = eng.add_request([1] * 8, SamplingParams(max_new_tokens=24))
        b = eng.add_request([2] * 8, SamplingParams(max_new_tokens=24))
        ta, ca = _drain_stream(eng, a)
        tb, cb = _drain_stream(eng, b)
        assert len(ta) == 24 and len(tb) == 24
        assert ca["finish_reason"] == cb["finish_reason"] == "length"
    finally:
        eng.stop()


def test_drain_finishes_in_flight_and_sheds_new():
    eng = LLMEngine(ToyAdapter(per_seq_delay_s=0.002), EngineConfig(
        max_running=4, num_blocks=64, block_size=8, max_seq_len=128))
    try:
        sid = eng.add_request([1] * 4, SamplingParams(max_new_tokens=20))
        eng.prepare_drain()
        with pytest.raises(ReplicaOverloadedError):
            eng.add_request([2] * 4, SamplingParams(max_new_tokens=2))
        toks, ch = _drain_stream(eng, sid)
        assert len(toks) == 20 and eng.in_flight() == 0
    finally:
        eng.stop()


def test_spec_decode_toy_identity():
    assert greedy_verify([5, 7, 9], [7, 9, 4]) == [7, 9, 4]
    assert greedy_verify([5, 7, 9], [7, 1, 4]) == [7, 1]
    prompts = [[3, 4, 5], [9, 1, 1, 2, 7]]

    def run(spec_k):
        eng = LLMEngine(ToyAdapter(seed=1), EngineConfig(
            num_blocks=64, block_size=8, max_seq_len=128, spec_k=spec_k,
            draft_model_config={"seed": 1}))
        try:
            sids = [eng.add_request(p, SamplingParams(max_new_tokens=12))
                    for p in prompts]
            return [_drain_stream(eng, s)[0] for s in sids]
        finally:
            eng.stop()

    assert run(3) == run(0)


def test_unknown_models_raise_value_error():
    with pytest.raises(ValueError, match="unknown draft model"):
        make_draft("x")
    with pytest.raises(ValueError, match="unknown model"):
        make_adapter("x")
    with pytest.raises(ValueError, match="unknown model kind"):
        TorchModelAdapter("x", device="cpu")


# ------------------------------------------------- torch vs flax GPT-2


@pytest.fixture(scope="module")
def flax_adapter():
    # one adapter for every engine below: its jitted steps are cached
    # per (batch, length) bucket
    return FlaxModelAdapter("gpt2", seed=0)


# 4 requests of mixed prompt lengths; the last three share the first's
# 20-token prefix, so with the prefix cache they hit after it finishes
_PREFIX = list(np.random.RandomState(5).randint(0, 512, 20))
_REQUESTS = [(_PREFIX + [1, 2, 3], 6), (_PREFIX + [7], 5),
             (_PREFIX[:11], 7), (_PREFIX + [4] * 9, 4)]


def _generate(engine_cls, cfg_cls, sp_cls, adapter, prefix_cache):
    eng = engine_cls(adapter, cfg_cls(
        max_running=4, num_blocks=48, block_size=8, max_seq_len=64,
        enable_prefix_cache=prefix_cache))
    try:
        (p0, n0), rest = _REQUESTS[0], _REQUESTS[1:]
        first = [_drain_stream(eng, eng.add_request(
            [int(t) for t in p0], sp_cls(max_new_tokens=n0)))[0]]
        sids = [eng.add_request([int(t) for t in p], sp_cls(max_new_tokens=n))
                for p, n in rest]
        outs = first + [_drain_stream(eng, s)[0] for s in sids]
        return outs, eng.metrics()
    finally:
        eng.stop()


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_torch_adapter_matches_flax_adapter(flax_adapter, prefix_cache):
    ref, _ = _generate(JLLMEngine, JEngineConfig, JSamplingParams,
                       flax_adapter, prefix_cache)
    port = TorchModelAdapter("gpt2", params=flax_adapter.params,
                             device="cpu")
    got, m = _generate(LLMEngine, EngineConfig, SamplingParams, port,
                       prefix_cache)
    assert got == ref
    assert [len(t) for t in got] == [n for _, n in _REQUESTS]
    assert port.decode_steps > 0
    if prefix_cache:
        assert m["cache_hit_tokens_total"] > 0


def test_torch_adapter_speculative_windows_are_token_identical():
    """``decode_window`` (padded multi-token paged steps) + rollback:
    greedy speculation with a toy draft gives the plain decode's
    tokens, whatever the draft proposes."""
    prompts = [list(range(3, 14)), [9, 1, 1, 2, 7]]

    def run(spec_k):
        eng = LLMEngine(TorchModelAdapter("gpt2", device="cpu"),
                        EngineConfig(num_blocks=32, block_size=8,
                                     max_seq_len=64, spec_k=spec_k,
                                     draft_model_config={"vocab_size": 512}))
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


def test_torch_adapter_export_import_roundtrip():
    src = TorchModelAdapter("gpt2", device="cpu")
    dst = TorchModelAdapter("gpt2", device="cpu")
    for a in (src, dst):
        a.bind_cache(PagedKVCache(num_blocks=16, block_size=8))

    class Seq:
        def __init__(self, seq_id, prompt):
            self.seq_id, self.prompt, self.tokens = seq_id, prompt, []

    prompt = list(range(1, 13))
    src.cache.allocate("s", 20)
    dst.cache.allocate("filler", 8)      # different physical pages
    dst.cache.allocate("d", 20)
    logits = src.prefill([Seq("s", prompt)])
    dst.import_kv("d", len(prompt), src.export_kv("s", len(prompt)))
    nxt = int(logits[0].argmax())
    seq_s, seq_d = Seq("s", prompt), Seq("d", prompt)
    seq_s.tokens = seq_d.tokens = [nxt]
    np.testing.assert_array_equal(src.decode([seq_s]), dst.decode([seq_d]))
    with pytest.raises(ValueError):
        dst.import_kv("d", len(prompt), {"kind": "toy"})


# ----------------------------------------------------------- the server


def test_llm_server_answers_a_request():
    server = LLMServer(model="gpt2", model_config={"device": "cpu"},
                       engine_config={"num_blocks": 32, "block_size": 8})
    try:
        # tiny GPT-2 has 256 positions: the server caps max_seq_len there
        assert server.engine.config.max_seq_len == 256
        out = server({"prompt": "hello", "max_new_tokens": 5})
        assert out["n_tokens"] == 5 and out["finish_reason"] == "length"
        assert all(0 <= t < 512 for t in out["tokens"])
        sid = server.__llm_open__({"tokens": [1, 2, 3],
                                   "max_new_tokens": 3})["stream_id"]
        toks, ch = _drain_stream(server.engine, sid)
        assert len(toks) == 3 and ch["finish_reason"] == "length"
        assert server.__serve_load__()["queue_len_extra"] == 0
        assert server.__llm_metrics__()["finished_total"] == 2
        with pytest.raises(ValueError, match="token ids"):
            server({"tokens": [600]})
    finally:
        server.__serve_prepare_shutdown__()


def test_gpt2_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: this checks the CPU-only refusal")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LLMServer(model="gpt2", model_config={"config": GPT2Config.tiny()})
