"""The port's prefill/decode disaggregation against the JAX package's,
on the CPU.

``LLMEngine.prefill_export`` / ``take_export`` / ``adopt_request`` and
``KVShipper``'s inline lane carry a prompt's KV from one engine to
another: with the toy model (``tests/test_llm_fleet.py``'s scenario) and
with GPT-2 tiny (the port's ``TorchModelAdapter`` from the same flax
params as the JAX ``FlaxModelAdapter``), the port gives the JAX
package's tokens and ledgers exactly (greedy), and both pools end
empty. ``LLMServer.__llm_prefill__`` / ``__llm_adopt__`` re-prefill, to
the same tokens, on a corrupt frame and on a blob of another adapter.
"""

import time

import numpy as np
import pytest
import torch

from ray_tpu.serve.llm import EngineConfig as JEngineConfig
from ray_tpu.serve.llm import FlaxModelAdapter
from ray_tpu.serve.llm import KVShipper as JKVShipper
from ray_tpu.serve.llm import LLMEngine as JLLMEngine
from ray_tpu.serve.llm import SamplingParams as JSamplingParams
from ray_tpu.serve.llm import ToyAdapter as JToyAdapter
from ray_tpu_torch.serve.exceptions import ReplicaOverloadedError
from ray_tpu_torch.serve.llm import (EngineConfig, KVShipError, KVShipper,
                                     LLMEngine, LLMServer, SamplingParams,
                                     TorchModelAdapter, ToyAdapter)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# Long enough for a jit compile on a loaded box (six test processes at
# once): both waits return as soon as their event lands.
_COMPILE_S = 300.0


def _drain(eng, sid, timeout=_COMPILE_S):
    toks, cur = [], 0
    deadline = time.time() + timeout
    while time.time() < deadline:
        ch = eng.poll(sid, cur, max_wait_s=5.0)
        toks += ch["tokens"]
        cur = ch["cursor"]
        if ch["done"]:
            return toks, ch
    raise TimeoutError(f"stream {sid} never finished")


JAX = dict(Engine=JLLMEngine, Config=JEngineConfig, Sampling=JSamplingParams,
           Shipper=JKVShipper)
PORT = dict(Engine=LLMEngine, Config=EngineConfig, Sampling=SamplingParams,
            Shipper=KVShipper)
_CFG = dict(num_blocks=64, block_size=8, max_seq_len=256, max_running=8)


def _unified(side, adapter, prompts, ntok):
    eng = side["Engine"](adapter, side["Config"](**_CFG))
    try:
        out = []
        for i, p in enumerate(prompts):
            sid = eng.add_request(list(p), side["Sampling"](
                max_new_tokens=ntok), request_id=f"r{i}")
            out.append(_drain(eng, sid)[0])
        return out
    finally:
        eng.stop()


def _disagg(side, make_adapter, prompts, ntok):
    """test_llm_fleet.py:331's flow: prefill_export -> take_export ->
    ship -> receive -> adopt_request on a second engine."""
    pe = side["Engine"](make_adapter(), side["Config"](**_CFG))
    de = side["Engine"](make_adapter(), side["Config"](**_CFG))
    shipper = (side["Shipper"]("test") if side is JAX
               else side["Shipper"]())
    try:
        outs, firsts = [], []
        for i, p in enumerate(prompts):
            sampling = side["Sampling"](max_new_tokens=ntok)
            sid = pe.prefill_export(list(p), sampling, request_id=f"r{i}")
            toks, _ = _drain(pe, sid)
            export = pe.take_export(sid, max_wait_s=_COMPILE_S)
            assert export is not None and export["first_token"] == toks[0]
            assert export["finish_reason"] == "length"
            desc = shipper.ship({"kv": export["kv"]})
            assert desc["lane"] == "inline"
            frame = shipper.receive(desc)
            did = de.adopt_request(list(p), export["first_token"],
                                   frame["kv"], sampling, request_id=f"r{i}")
            dtoks, dch = _drain(de, did)
            assert not dch.get("error"), dch
            outs.append(dtoks)
            firsts.append(export["first_token"])
        return {"tokens": outs, "firsts": firsts,
                "prefill_ledger": sorted(pe.token_ledger()),
                "decode_ledger": sorted(de.token_ledger()),
                "pages": (pe.metrics()["kv_blocks_used"],
                          de.metrics()["kv_blocks_used"]),
                "decode_metrics": de.metrics()}
    finally:
        pe.stop()
        de.stop()


def test_toy_disagg_matches_jax_and_unified():
    """test_llm_fleet.py:331 on both packages' toy engines: the tokens
    equal the unified engine's and JAX's; the ledgers split into
    handoff rows (1 token) and completion rows, the decode side counting
    the whole prompt as cached; both pools end at 0 used pages."""
    rng = np.random.RandomState(29)
    prompts = [[int(t) for t in rng.randint(0, 256, n)] for n in (21, 9, 33)]
    unified = _unified(PORT, ToyAdapter(), prompts, 12)
    got = _disagg(PORT, ToyAdapter, prompts, 12)
    ref = _disagg(JAX, JToyAdapter, prompts, 12)
    assert got["tokens"] == unified == ref["tokens"]
    for k in ("prefill_ledger", "decode_ledger", "pages"):
        assert got[k] == ref[k], k
    assert all(r[2] == "handoff" and r[1] == 1 for r in got["prefill_ledger"])
    assert all(r[2] == "length" and r[1] == 12 for r in got["decode_ledger"])
    assert [r[4] for r in got["decode_ledger"]] == [len(p) for p in prompts]
    assert got["pages"] == (0, 0)
    assert got["decode_metrics"]["cache_hit_tokens_total"] == sum(
        len(p) for p in prompts)


def _gpt2_prompts():
    rng = np.random.RandomState(31)
    return [[int(t) for t in rng.randint(0, 512, n)] for n in (13, 8, 21)]


def _jax_twins(first):
    """``make_adapter`` for ``_disagg``: ``first``, then a second adapter
    on the same params sharing its jitted steps (an engine binds its
    adapter's pool, so the decode engine needs its own adapter)."""
    twins = iter([first, FlaxModelAdapter("gpt2", params=first.params)])

    def make():
        a = next(twins)
        a._fns = first._fns
        return a
    return make


@pytest.fixture(scope="module")
def flax_adapter():
    """The JAX adapter, with the jitted steps the GPT-2 test runs
    (prefill buckets, decode, KV export and import) compiled here, by one
    disaggregated pass over the same prompts on adapters that share its
    steps, before any of the test's waits starts."""
    adapter = FlaxModelAdapter("gpt2", seed=0)
    warm = FlaxModelAdapter("gpt2", params=adapter.params)
    warm._fns = adapter._fns
    _disagg(JAX, _jax_twins(warm), _gpt2_prompts(), 6)
    return adapter


def test_gpt2_disagg_matches_flax_adapter(flax_adapter):
    """GPT-2 tiny (f32): the port's TorchModelAdapter engines, from the
    flax adapter's params, give the JAX engines' disaggregated tokens
    (and first tokens) exactly, which are the unified ones; the pages
    partly filled at the prompt's end are shipped whole and masked by
    the lengths."""
    prompts = _gpt2_prompts()

    def port_adapter():
        return TorchModelAdapter("gpt2", params=flax_adapter.params,
                                 device="cpu")

    ref = _disagg(JAX, _jax_twins(flax_adapter), prompts, 6)
    got = _disagg(PORT, port_adapter, prompts, 6)
    assert got["tokens"] == ref["tokens"]
    assert got["firsts"] == ref["firsts"]
    assert got["decode_ledger"] == ref["decode_ledger"]
    assert got["pages"] == (0, 0)
    assert got["tokens"] == _unified(PORT, port_adapter(), prompts, 6)


def test_shipper_crc_length_and_lane():
    """test_llm_fleet.py:375: a flipped byte fails the CRC and receive()
    returns None (re-prefill), not garbage; so does a frame of the wrong
    length; a lane this side cannot fetch raises KVShipError; torch
    tensors cross intact."""
    shipper = KVShipper()
    pages = torch.arange(64, dtype=torch.float32).reshape(2, 8, 4)
    desc = shipper.ship({"kv": {"kind": "toy", "n": 3, "pages": pages,
                                "bf16": pages.to(torch.bfloat16)}})
    assert desc["lane"] == "inline" and desc["n"] == len(desc["b"])
    back = shipper.receive(dict(desc))["kv"]
    assert torch.equal(back["pages"], pages)
    assert back["bf16"].dtype == torch.bfloat16
    body = bytearray(desc["b"])
    body[len(body) // 2] ^= 0x5A
    assert shipper.receive(dict(desc, b=bytes(body))) is None
    assert shipper.receive(dict(desc, b=desc["b"][:-1])) is None
    assert shipper.receive(dict(desc, b=None)) is None
    with pytest.raises(KVShipError):
        shipper.receive({"lane": "plasmax", "o": "00", "crc": 0, "n": 0})


def _toy_server(**engine):
    return LLMServer("toy", engine_config={**_CFG, **engine})


def test_server_hops_and_reprefill_fallbacks():
    """Two toy servers in their roles: adopted streams give the unified
    tokens; a corrupt frame and a blob of another adapter ("torch:gpt2"
    on a toy decode server) re-prefill to the same tokens with
    ``adopted: False``, leaving no page behind; a stream that the first
    token ends (max_new_tokens 1, or the stop token) is adopted without
    a frame."""
    pre, dec = _toy_server(), _toy_server()
    try:
        payload = {"tokens": list(range(3, 30)), "max_new_tokens": 9}
        want = dec(payload)["tokens"]
        h = pre.__llm_prefill__(payload)
        assert h["first_token"] == want[0] and h["kv"]["lane"] == "inline"
        r = dec.__llm_adopt__(h)
        assert r["adopted"] and _drain(dec.engine, r["stream_id"])[0] == want

        h = pre.__llm_prefill__(payload)
        body = bytearray(h["kv"]["b"])
        body[len(body) // 3] ^= 0xFF
        r = dec.__llm_adopt__(dict(h, kv=dict(h["kv"], b=bytes(body))))
        assert not r["adopted"]
        assert _drain(dec.engine, r["stream_id"])[0] == want

        h = pre.__llm_prefill__(payload)
        frame = pre._get_shipper().receive(h["kv"])
        frame["kv"]["kind"] = "torch:gpt2"
        r = dec.__llm_adopt__(dict(h, kv=pre._get_shipper().ship(frame)))
        assert not r["adopted"]
        assert _drain(dec.engine, r["stream_id"])[0] == want

        one = pre.__llm_prefill__(dict(payload, max_new_tokens=1))
        assert "kv" not in one
        r = dec.__llm_adopt__(one)
        toks, ch = _drain(dec.engine, r["stream_id"])
        assert r["adopted"] and toks == want[:1]
        assert ch["finish_reason"] == "length"
        stop = pre.__llm_prefill__(dict(payload, stop_token=want[0]))
        r = dec.__llm_adopt__(stop)
        toks, ch = _drain(dec.engine, r["stream_id"])
        assert r["adopted"] and toks == want[:1]
        assert ch["finish_reason"] == "stop"
        for s in (pre, dec):
            assert s.engine.metrics()["kv_blocks_used"] == 0
    finally:
        for s in (pre, dec):
            s.__serve_prepare_shutdown__()


def test_adopt_sheds_when_the_pool_is_full_and_frees_on_a_bad_blob():
    """adopt_request: no pages left -> a retriable ReplicaOverloadedError
    (nothing left behind); an import that raises frees its pages; a
    KV blob is required unless the first token ends the stream."""
    pe = LLMEngine(ToyAdapter(), EngineConfig(**_CFG))
    de = LLMEngine(ToyAdapter(), EngineConfig(**dict(_CFG, num_blocks=5)))
    try:
        prompt = list(range(1, 20))
        sid = pe.prefill_export(prompt, SamplingParams(max_new_tokens=8))
        _drain(pe, sid)
        export = pe.take_export(sid)
        sampling = SamplingParams(max_new_tokens=8)
        filler = de.cache.allocate("filler", 16)   # 2 of 4 usable pages
        with pytest.raises(ReplicaOverloadedError):
            de.adopt_request(prompt, export["first_token"], export["kv"],
                             sampling)
        assert de.metrics()["shed_total"] == 1
        de.cache.free("filler")
        assert filler
        with pytest.raises(ValueError):
            de.adopt_request(prompt, export["first_token"],
                             {"kind": "other"}, sampling)
        assert de.metrics()["kv_blocks_used"] == 0
        with pytest.raises(ValueError, match="KV blob"):
            de.adopt_request(prompt, export["first_token"], None, sampling)
        did = de.adopt_request(prompt, export["first_token"], export["kv"],
                               sampling)
        assert len(_drain(de, did)[0]) == 8
        assert pe.take_export("missing", max_wait_s=0.0) is None
    finally:
        pe.stop()
        de.stop()


def test_bench_disagg_loop_on_cpu():
    from ray_tpu_torch import bench
    r = bench.disagg_loop(device="cpu", new_tokens=6)
    assert r["disagg_tokens"] == r["disagg_unified_tokens"]
    assert r["disagg_solo_tokens"] == r["disagg_solo_unified_tokens"]
    assert all(r["disagg_adopted"]) and all(r["disagg_solo_adopted"])
    assert not r["disagg_reprefill_adopted"]
    assert r["disagg_reprefill_tokens"] == r["disagg_solo_unified_tokens"][0]
    assert r["disagg_decode_steps"]["prefill"] == 0
    assert r["disagg_pages_used_at_end"] == {"prefill": 0, "decode": 0}
    assert min(r["disagg_handoff_bytes"]) > 0
