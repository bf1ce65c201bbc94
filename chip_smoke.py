#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one H100.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device  — a CUDA card of compute capability 9.0; prints its name and
             power limit (nvidia-smi); TF32 off for the f32 checks.
2. build   — compiles every kernel in ray_tpu_torch/kernels/csrc from
             the checkout, one nvcc per source, in parallel.
3. kernel  — each kernel's wrapper against its plain PyTorch version on
             the card, at the serving path's shapes and more: max error,
             kernel / plain time (CUDA events, L2 flushed between
             launches) and the least time the card could take.
4. serve   — GPT-2 small at full width and depth (random weights from a
             seed) behind the port's LLMServer: 16 concurrent streams of
             64 greedy tokens. Launch counts are zeroed just before and
             read just after: the paged-decode kernel must account for
             every layer of every decode step.
5. numerics — the same GPT-2 cast to f32: one batched decode step
             through the kernel against the same step with the plain
             version passed explicitly, and against the full forward.
6. summary — nvidia-smi's card line, the kernels line, then the
             device line, last.

Exits non-zero without printing a result when CUDA is absent or when
the repository's package is not beside this script.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # f32 outside the tensor cores
SEED = 0


def require(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def time_ms(fn, flush, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each after an
    L2 flush, timed with CUDA events around the launch alone."""
    import torch
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def paged_case(name, B, H, Hkv, D, bs, NB, lengths, dtype, tol, flush):
    """Kernel vs plain version on one shape; returns the measurements."""
    import torch
    from ray_tpu_torch.ops import attention as A
    g = torch.Generator().manual_seed(SEED)
    P = 1 + B * NB
    dt = getattr(torch, dtype)
    q = torch.randn(B, H, D, generator=g).to("cuda", dt)
    k = torch.randn(P, bs, Hkv, D, generator=g).to("cuda", dt)
    v = torch.randn(P, bs, Hkv, D, generator=g).to("cuda", dt)
    tables = (1 + torch.randperm(B * NB, generator=g)).reshape(B, NB).to(
        "cuda", torch.int32)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
    out = A.paged_attention_decode(q, k, v, tables, lens)
    torch.cuda.synchronize()
    ref = A.paged_attention_reference(q, k, v, tables, lens)
    err = float((out.float() - ref.float()).abs().max())
    require(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
    require(err <= tol, f"{name}: max error {err} > {tol}")
    ms = time_ms(lambda: A.paged_attention_decode(q, k, v, tables, lens),
                 flush)
    plain_ms = time_ms(
        lambda: A.paged_attention_reference(q, k, v, tables, lens), flush)
    elt = q.element_size()
    pages = [min(math.ceil(n / bs), NB) for n in lengths]
    kv_bytes = sum(pages) * bs * Hkv * D * elt * 2
    nbytes = kv_bytes + 2 * q.numel() * elt + 4 * (sum(pages) + B)
    flops = 4 * sum(lengths) * H * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    res = {"case": name, "dtype": dtype, "max_abs_err": err, "tol": tol,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes}
    print("kernel", json.dumps(res))
    return res


def ragged(rng, B, lo, hi):
    lens = rng.randint(lo, hi + 1, size=B)
    lens[0], lens[-1] = lo, hi
    return [int(n) for n in lens]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from ray_tpu_torch import kernels
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.serve.llm import LLMServer

    # 1. device
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    require(cap == (9, 0), f"{name} has compute capability {cap}, want 9.0")
    card = card_line()
    print(f"device: {name} | nvidia-smi: {card} | torch {torch.__version__}"
          f" cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)

    # 2. build
    t0 = time.time()
    libs = kernels.build()
    print(f"build: {sorted(libs)} in {time.time() - t0:.2f} s", flush=True)

    # 3. kernel against its plain version
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_        # 256 MB write evicts the 50 MB L2
    rng = np.random.RandomState(SEED)
    slice_lens = ragged(rng, 16, 1, 1024)
    main_case = paged_case("a: serve shape", 16, 12, 12, 64, 16, 64,
                           slice_lens, "bfloat16", 2e-2, flush)
    paged_case("a: serve shape", 16, 12, 12, 64, 16, 64, slice_lens,
               "float32", 1e-4, flush)
    paged_case("b: gqa", 16, 32, 8, 128, 16, 64, ragged(rng, 16, 1, 1024),
               "bfloat16", 2e-2, flush)
    paged_case("c: test_llm_serving tiny", 3, 8, 2, 16, 8, 4, [5, 17, 30],
               "float32", 1e-4, flush)
    del scratch

    # 4. serve GPT-2 small through the port's entry points
    cfg = gpt2.GPT2Config.small()
    server = LLMServer(
        model="gpt2", model_config={"config": cfg, "seed": SEED},
        engine_config={"max_running": 16, "max_seq_len": 1024,
                       "block_size": 16, "num_blocks": 1025})
    try:
        warm = server({"tokens": [464, 3290, 318], "max_new_tokens": 4})
        require(warm["n_tokens"] == 4, f"warm-up request: {warm}")
        prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
                   for n in rng.randint(64, 769, size=16)]
        kernels.reset_launch_counts()
        server.adapter.decode_steps = 0
        t0 = time.time()
        sids = [server.__llm_open__({"tokens": p, "max_new_tokens": 64})
                ["stream_id"] for p in prompts]
        results = []
        for sid in sids:
            toks, cursor = [], 0
            while True:
                chunk = server.__llm_next__(sid, cursor, max_wait_s=60.0)
                toks += chunk["tokens"]
                cursor = chunk["cursor"]
                if chunk["done"]:
                    break
            results.append((toks, chunk))
        wall = time.time() - t0
        launches = kernels.launch_counts().get("paged_attention_decode", 0)
        steps = server.adapter.decode_steps
    finally:
        server.engine.stop()
    for toks, chunk in results:
        require(not chunk.get("error"), f"stream failed: {chunk}")
        require(len(toks) == 64 and chunk["finish_reason"] == "length",
                f"stream ended with {len(toks)} tokens: {chunk}")
        require(all(0 <= t < cfg.vocab_size for t in toks), "token range")
    require(steps > 0 and launches == cfg.n_layer * steps,
            f"paged_attention_decode launched {launches} times over "
            f"{steps} decode steps of {cfg.n_layer} layers")
    ttft = sorted(c["ttft_s"] for _, c in results)
    print("serve", json.dumps({
        "model": "gpt2-small", "streams": 16, "new_tokens": 64,
        "prompt_tokens": [len(p) for p in prompts],
        "wall_s": wall, "tokens_per_s": 16 * 64 / wall,
        "ttft_p50_s": ttft[len(ttft) // 2], "ttft_p99_s": ttft[-1],
        "decode_steps": steps, "kernel_launches": launches,
        "device": name, "nvidia_smi": card}), flush=True)

    # 5. decode-step numerics in f32: kernel vs plain vs full forward
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                attention_backend="reference")
    m32 = gpt2.GPT2(cfg32)
    m32.load_state_dict(server.adapter.model.state_dict())
    m32 = m32.cuda().eval()
    del server
    B, bs, NB = 8, 16, 64
    n_prompt = np.asarray(ragged(rng, B, 37, 700), np.int64)
    ids = rng.randint(0, cfg.vocab_size, size=(B, int(n_prompt.max()) + 1))
    hd = cfg.n_embd // cfg.n_head
    tables = torch.arange(1, 1 + B * NB, dtype=torch.int32,
                          device="cuda").reshape(B, NB)
    caches = [{"k_pages": torch.zeros(1 + B * NB, bs, cfg.n_head, hd,
                                      device="cuda"),
               "v_pages": torch.zeros(1 + B * NB, bs, cfg.n_head, hd,
                                      device="cuda"),
               "block_tables": tables} for _ in range(cfg.n_layer)]
    S = 1 << int(n_prompt.max() - 1).bit_length()   # the adapter's bucket
    valid = np.arange(S)[None, :] < n_prompt[:, None]
    prompt = np.zeros((B, S), np.int64)
    for b in range(B):
        prompt[b, :n_prompt[b]] = ids[b, :n_prompt[b]]
    lens = torch.as_tensor(n_prompt, dtype=torch.int32, device="cuda")
    tok = torch.as_tensor(ids[np.arange(B), n_prompt][:, None],
                          device="cuda")
    with torch.no_grad():
        m32(torch.as_tensor(prompt, device="cuda"), kv_cache=caches,
            seq_lengths=torch.zeros(B, dtype=torch.int32, device="cuda"),
            valid=torch.as_tensor(valid, device="cuda"))
        kernels.reset_launch_counts()
        via_kernel, _ = m32(tok, kv_cache=caches, seq_lengths=lens)
        require(kernels.launch_counts().get("paged_attention_decode")
                == cfg.n_layer, "f32 decode step missed the kernel")
        via_plain, _ = m32(tok, kv_cache=caches, seq_lengths=lens,
                           paged_decode=A.paged_attention_reference)
        err_plain = float((via_kernel - via_plain).abs().max())
        err_full = 0.0
        for b in range(B):
            n = int(n_prompt[b]) + 1
            full = m32(torch.as_tensor(ids[b:b + 1, :n], device="cuda"))
            err_full = max(err_full, float(
                (via_kernel[b, 0] - full[0, -1]).abs().max()))
    require(bool(torch.isfinite(via_kernel).all())
            and via_kernel.shape == (B, 1, cfg.vocab_size),
            f"decode logits {tuple(via_kernel.shape)} not finite")
    require(err_plain <= 1e-3, f"kernel vs plain decode step: {err_plain}")
    require(err_full <= 1e-3, f"decode step vs full forward: {err_full}")
    print("numerics", json.dumps({"dtype": "float32", "batch": B,
                                  "max_abs_err_vs_plain": err_plain,
                                  "max_abs_err_vs_full_forward": err_full,
                                  "tol": 1e-3}), flush=True)

    # 6. summary
    summary = {"kernels": [{
        "name": "paged_attention_decode", "route": "cuda",
        "source": "ray_tpu_torch/kernels/csrc/paged_decode.cu",
        "replaces": "ray_tpu/ops/attention.py:803",
        "launches": launches, "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": None}]}
    print(card)                  # nvidia-smi's name, power.limit line
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
