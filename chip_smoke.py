#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one H100.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device   — a CUDA card of compute capability 9.0; prints its name and
              power limit (nvidia-smi); TF32 off for the f32 checks.
2. build    — compiles every kernel in ray_tpu_torch/kernels/csrc from
              the checkout, one nvcc per source, in parallel; prints
              the registers, spills and shared memory per CTA of the
              streaming kernels' bf16 bodies.
3. kernel   — each kernel's wrapper against its plain PyTorch version on
              the card, at the main paths' shapes and more: max error
              against a stated tolerance, kernel / plain / library time
              (CUDA events, L2 flushed between launches) and the least
              time the card could take. Paged decode at the serving
              shapes; the whole-kv attention forward and backward at
              GPT-2 training's b16 h12 s1024 d64 bf16, at the entry
              shape b4 h12 s512, at Llama-2-7B's preset shape b1 h32
              s2048 d128, at a small f32 shape and at shapes whose
              scaled logits pass the 50 cap (f32 and bf16); the
              streaming forward, dkv and dq kernels at Llama-2-7B
              training's b2 h32 s4096 d128 bf16, at GPT-2's shape, at
              small f32 shapes (a ragged 2064 = 16 * 129, sq != sk with
              the top-left causal mask, not causal), at the same edges
              in bf16 for the wgmma backward (d 64 and 128; 1040 and
              2064, not multiples of 64 or 128) and past the cap.
              In bf16 each kernel and its plain version are both held to
              the function in f64 (attention_case, hold_outputs).
4. serve    — GPT-2 small at full width and depth (random weights from a
              seed) behind the port's LLMServer: 16 concurrent streams of
              64 greedy tokens. Launch counts are zeroed just before and
              read just after: the paged-decode kernel must account for
              every layer of every decode step.
5. numerics — the same GPT-2 cast to f32: one batched decode step
              through the kernel against the same step with the plain
              version passed explicitly, and against the full forward.
6. train    — make_causal_lm_trainer(GPT2Config.small()) on the card,
              batch 16 x 1024 of seeded tokens: warm-up steps, then
              timed windows with the launch counts zeroed before and
              read after (each whole-kv kernel exactly n_layer times a
              step); the loss is finite and falls on the repeated
              batch. Prints bench.py's gpt2_* keys and peak memory,
              then one profiled step's device time by kernel group.
7. train numerics — GPT-2 at full width, 2 layers, TF32 off: one
              trainer step through the kernels against one through
              their plain versions (passed explicitly), in f32 (loss,
              grad_norm, grads, updated params) and in bf16 compute,
              the training path's (loss, grad_norm, and grads held to
              the f32 step; train_parity).
8. llama    — the Llama loop (llama.train_step: forward, causal_lm_loss,
              backward, optax.adamw(3e-4)'s AdamW) on a Llama-2-7B-wide
              decoder (dim 4096, 32 heads, d 128, ffn 11008, vocab
              32000; 4 layers; bf16 compute, f32 params) at batch
              2 x 4096 of seeded tokens: s = 4096 takes the streaming
              kernels by its shape. Warm-up steps, then timed windows
              with the launch counts zeroed before and read after (each
              streaming kernel exactly n_layers times a step, no
              whole-kv launch); the loss is finite and falls. Prints
              step time, tokens/s, peak memory and one profiled step.
9. llama numerics — the same model at 2 layers, batch 1 x 4096: one
              loop step through the streaming kernels against one
              through their plain versions, in f32 and in bf16
              (llama_parity, the rules of train_parity).
10. entry   — ray_tpu_torch.entry.entry() on the card: logits
              (4, 512, 50257), finite, one forward kernel per layer.
11. summary — nvidia-smi's card line, the kernels line, then the
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
# profile_step's kernel groups, by substrings of the kernel's name: the
# port's attention kernels, then f32 products (SIMT sgemm: Llama's f32
# LM head, TF32 off), then the other matrix products (cuBLAS/CUTLASS)
PROFILE_GROUPS = (
    ("whole_kv_attention", ("whole_fwd", "whole_bwd")),
    ("streaming_attention", ("flash_fwd", "flash_dkv", "flash_dq")),
    ("matmul_f32", ("sgemm", "f32f32_f32f32")),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas", "sm90_")))
# whole-kv kernels against their plain versions: f32 within F32_TOL of
# each output's scale; bf16 within BF16_RATIO = (max, rms) times the
# plain version's own error against the f64 yardstick (hold_outputs). In
# a training step through them (train_parity): bf16 grads within
# BF16_RATIO times the plain step's error against the f32 step, loss
# and grad_norm within BF16_STEP_REL; f32 params within 1e-6 where the
# plain step's |grad| passes PARAM_MASK. Measured on an H100 (PERF.md):
# the bf16 ratios came to at most 1.55 (max) and 1.03 (rms); the
# relative loss and grad_norm gaps to 7.1e-5.
F32_TOL = 1e-5
BF16_RATIO = (3.0, 1.25)
BF16_STEP_REL = 5e-4
PARAM_MASK = 1e-6


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


def hold_outputs(name, dtype, outs, refs) -> dict:
    """Holds each kernel output to its plain version's, ``outs`` = {name:
    (kernel, plain)} in the order o, lse, dq, dk, dv:

    f32 outputs (all of them for f32 inputs; lse for bf16 inputs, which
          neither side rounds to bf16):
          max |kernel - plain| <= F32_TOL * (1 + max |plain|): the two
          only sum in another order;
    bf16 outputs: both round p, ds and the outputs, so each is measured
          against the function in f64 on the same inputs (``refs()``,
          the f64 yardsticks in the same order), and the kernel's max
          and rms error may be at most BF16_RATIO times the plain
          version's (``error_ratios``).

    Prints the check, fails the run outside the tolerance, and returns
    the max |kernel - plain| of each output."""
    import torch
    require(all(bool(torch.isfinite(a).all()) for a, _ in outs.values()),
            f"{name}: non-finite kernel output")
    abs_err = {n: float((a.float() - b.float()).abs().max())
               for n, (a, b) in outs.items()}
    held, bad = held_outputs(list(outs.values()), refs, list(outs))
    print("kernel_check", json.dumps({"case": name, "dtype": dtype,
                                      "max_abs_err": abs_err, "held": held,
                                      "tol": {"float32": F32_TOL,
                                              "bfloat16": BF16_RATIO}}),
          flush=True)
    require(not bad, f"{name}: {bad} outside their tolerance: {held}")
    return abs_err


def held_outputs(pairs, refs, names):
    """``hold_outputs``'s rule on [(kernel, plain), ...]: (held, bad),
    held[name] = the f32 measure (a float) or the bf16 ratios (max,
    rms); bad = the names outside F32_TOL or BF16_RATIO. ``refs()`` is
    called only when some output is bf16."""
    from ray_tpu_torch.ops import attention as A
    import torch
    ref = refs() if any(a.dtype != torch.float32 for a, _ in pairs) else None
    held, bad = {}, []
    for i, (n, (a, b)) in enumerate(zip(names, pairs)):
        if a.dtype == torch.float32:
            held[n] = float((a - b.float()).abs().max()) / (
                1 + float(b.float().abs().max()))
            ok = held[n] <= F32_TOL
        else:
            held[n] = A.error_ratios(a, b, ref[i])
            ok = held[n][0] <= BF16_RATIO[0] and held[n][1] <= BF16_RATIO[1]
        if not ok:
            bad.append(n)
    return held, bad


def causal_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """(query, key) pairs a head computes: with the top-left causal mask
    row r sees min(r + 1, Sk) keys (bottom-right = top-left at Sq = Sk)."""
    if not causal:
        return Sq * Sk
    n = min(Sq, Sk)
    return n * (n + 1) // 2 + max(Sq - Sk, 0) * Sk


# what each attention wrapper's function must move and compute: tensors
# of q's shape and of k's shape read or written once, f32 rows (lse,
# delta), and products of 2 * D flops per causal pair
ATTENTION_WORK = {   # kernel: (q-shaped, k-shaped, f32 rows, products)
    # q, k, v in, o and lse out; s = q.k^T, e.v
    "whole_attention_forward": (2, 2, 1, 2),
    # q, k, v, o, do, lse in (delta inside), dq, dk, dv out; s, dp, dq,
    # dk, dv
    "whole_attention_backward": (5, 3, 1, 5),
    "flash_attention_forward": (2, 2, 1, 2),
    # q, k, v, do, lse, delta in, dk, dv out; s, dp, dv, dk
    "flash_attention_backward_dkv": (2, 4, 2, 4),
    # the same in, dq out; s, dp, dq
    "flash_attention_backward_dq": (3, 2, 2, 3)}


def attention_bound(kname, B, H, Sq, Sk, D, dtype, causal):
    """(bound_ms, bound_by, bytes, flops) of one attention wrapper's
    function (ATTENTION_WORK), causal pairs only."""
    n_q, n_k, n_rows, products = ATTENTION_WORK[kname]
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = ((n_q * Sq + n_k * Sk) * D * elt + n_rows * Sq * 4) * B * H
    flops = 2 * D * products * B * H * causal_pairs(Sq, Sk, causal)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def max_logit(q, k) -> float:
    """The largest q.k over all heads, a few heads at a time."""
    import torch
    B, H = q.shape[:2]
    return max(float(torch.einsum("hqd,hkd->hqk", q[b, h:h + 4].float(),
                                  k[b, h:h + 4].float()).max())
               for b in range(B) for h in range(0, H, 4))


def attention_case(path, name, B, H, Sq, Sk, D, dtype, causal, flush,
                   scale=1.0) -> dict:
    """One training-attention path's kernels against their plain
    versions on one shape: ``path`` "whole" (the whole-kv forward and
    one backward launch; Sq = Sk) or "flash" (the streaming forward and
    the backward as two launches, dkv and dq; plain versions at the
    blocks flash_attention fits to the shape). Each of o, lse, dq, dk
    and dv is held by ``hold_outputs`` (bf16 yardsticks:
    ``{path}_attention_*_f64``, the streaming ones a few heads at a
    time). The backwards start from the plain forward's o and lse, so
    each kernel is held on its own. Returns {kernel name: its
    measurements}. The library yardstick is SDPA: its forward for the
    forward, its backward (dq, dk and dv in one call) for the backward,
    and for the streaming pair dkv + dq together (``library_covers``
    on both rows)."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import attention as A
    g = torch.Generator().manual_seed(SEED)
    dt = getattr(torch, dtype)

    def rand(s):
        return (torch.randn(B, H, s, D, generator=g) * scale).to("cuda", dt)
    q, k, v, do = rand(Sq), rand(Sk), rand(Sk), rand(Sq)
    q = (q * D ** -0.5).to(dt)      # pre-scaled, as flash_attention hands it
    s_max = max_logit(q, k)
    ro, rlse = getattr(A, f"{path}_attention_forward_reference")(
        q, k, v, causal=causal)
    fwd_args = (q, k, v)
    if path == "whole":
        bwd = {"whole_attention_backward": ("dq", "dk", "dv")}
        bwd_args = (q, k, v, ro, rlse, do)
    else:
        bwd = {"flash_attention_backward_dkv": ("dk", "dv"),
               "flash_attention_backward_dq": ("dq",)}
        bwd_args = (q, k, v, do, rlse, A._delta(ro, do))
    parts = {f"{path}_attention_forward": (fwd_args, ("o", "lse")),
             **{kname: (bwd_args, names) for kname, names in bwd.items()}}

    def run(kname, plain=False):
        args, _ = parts[kname]
        fn = getattr(A, kname + ("_reference" if plain else ""))
        return lambda: fn(*args, causal=causal)

    kernel_outs = {kname: run(kname)() for kname in parts}
    torch.cuda.synchronize()
    outs = {}
    for kname, (_, names) in parts.items():
        got, want = kernel_outs[kname], run(kname, plain=True)()
        got, want = ((got,), (want,)) if len(names) == 1 else (got, want)
        outs.update(zip(names, zip(got, want)))
    outs = {n: outs[n] for n in ("o", "lse", "dq", "dk", "dv")}

    def refs():
        f64 = getattr(A, f"{path}_attention_forward_f64"), getattr(
            A, f"{path}_attention_backward_f64")
        return (f64[0](q, k, v, causal=causal)
                + f64[1](q, k, v, ro, rlse, do, causal=causal))
    abs_err = hold_outputs(name, dtype, outs, refs)
    del outs, kernel_outs

    # the library calls, timed here and never called by the port
    lib_f = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, scale=1.0), flush)
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=causal,
                                         scale=1.0)
    lib_b = time_ms(lambda: torch.autograd.grad(
        out, (qq, kk, vv), do, retain_graph=True), flush)
    del out
    res = {}
    for kname, (_, names) in parts.items():
        bound, by, nbytes, flops = attention_bound(kname, B, H, Sq, Sk, D,
                                                   dtype, causal)
        forward = kname.endswith("_forward")
        r = {"case": name, "kernel": kname, "shape": [B, H, Sq, Sk, D],
             "dtype": dtype, "causal": causal,
             "max_scaled_logit": s_max,
             "max_abs_err": max(abs_err[n] for n in names),
             "ms": time_ms(run(kname), flush),
             "plain_ms": time_ms(run(kname, plain=True), flush, iters=3),
             "library_ms": lib_f if forward else lib_b,
             "library_covers": [kname] if forward else list(bwd),
             "bound_ms": bound, "bound_by": by,
             "bytes": nbytes, "flops": flops}
        print("kernel", json.dumps(r), flush=True)
        res[kname] = r
    if len(bwd) > 1:
        print("backward_pair", json.dumps({
            "case": name, "kernels_ms": sum(res[k]["ms"] for k in bwd),
            "sdpa_backward_ms": lib_b}), flush=True)
    return res


def profile_step(step) -> dict:
    """Device time of one training step by kernel group
    (PROFILE_GROUPS, first match by kernel name; the rest is
    elementwise, reductions, copies and the optimizer), from the kernel
    events of torch.profiler, with the ten largest kernels by name.
    Informational; the step runs after the launch counts were read."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {g: 0.0 for g, _ in PROFILE_GROUPS}
    groups["other"] = 0.0
    by_name = {}
    for ev in prof.events():
        # kernels, copies and sets; not the ranges that user annotations
        # (the optimizer's step) draw over them on the device
        if (ev.device_type != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        ms = ev.device_time_total / 1e3
        low = ev.name.lower()
        group = next((g for g, words in PROFILE_GROUPS
                      if any(w in low for w in words)), "other")
        groups[group] += ms
        tot, n = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (tot + ms, n + 1)
    busy = sum(groups.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_ms_profiled": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall_ms, "by_group_ms": groups,
            "top_kernels": [{"ms": ms, "calls": n, "name": name[:90]}
                            for name, (ms, n) in top]}


def one_step(cfg, impl, tokens) -> dict:
    """One trainer step from the seeded init with the flash backend on
    ``impl`` (kernels or plain versions): loss, grad_norm, the params
    after the step, their (clipped) grads and the launch counts of the
    step."""
    from ray_tpu_torch import kernels
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import spmd
    tr = spmd.make_causal_lm_trainer(cfg, model=gpt2.GPT2(cfg,
                                                          impl=impl))
    st = tr.init(SEED)
    batch = spmd.put_batch(tr, {"input_ids": tokens, "labels": tokens})
    kernels.reset_launch_counts()
    st, m = tr.step(st, batch)
    named = list(st["model"].named_parameters())
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": {k: p.detach().clone() for k, p in named},
            "grads": {k: p.grad.detach().clone() for k, p in named},
            "launches": kernels.launch_counts()}


def hold_step(tag, runs, info):
    """Holds a training step through the kernels to the same step
    through their plain versions. ``runs`` = {(dtype, "kernels" |
    "plain"): one_step-like dict}, both from the same seeded init and
    tokens, TF32 off.

    f32 compute (the CUDA-core kernel bodies): nothing is rounded to
    bf16, so loss and grad_norm agree within F32_TOL relative, and
    each grad within F32_TOL of its tensor's largest entry. AdamW's
    first step moves a param by lr * g / (|g| + eps) (and the decay,
    the same on both sides), whose slope in g is lr * eps / (|g| +
    eps)^2: where |g| is near eps = 1e-8, a grad that differs in its
    last bits moves the param up to lr apart. So the params are held
    to 1e-6 where the plain step's |g| > PARAM_MASK (= 100 eps; there
    the slope is under 3 and the update ~lr, 300 times the bound, so
    a step that left them unchanged fails), and the share of entries
    left out is printed.

    bf16 compute (the training path's dtype and tensor-core bodies):
    each leaf's grad is measured against the f32 plain step's, and the
    kernels' max and rms error may be at most BF16_RATIO times the
    plain versions' (``error_ratios``); loss and grad_norm agree
    within BF16_STEP_REL relative. The params are not compared: after
    the first AdamW step a param moves by about lr times the sign of
    its grad, which the grads check covers."""
    from ray_tpu_torch.ops import attention as A

    def rel(a, b):
        return abs(a - b) / abs(b)

    k32, p32 = runs["float32", "kernels"], runs["float32", "plain"]
    held = {n: g.abs() > PARAM_MASK for n, g in p32["grads"].items()}
    p_diff = {n: (k32["params"][n] - p).abs()
              for n, p in p32["params"].items()}
    f32 = {"loss_rel": rel(k32["loss"], p32["loss"]),
           "grad_norm_rel": rel(k32["grad_norm"], p32["grad_norm"]),
           "grads_rel_to_tensor_max": max(
               float((k32["grads"][n] - g).abs().max()
                     / g.abs().max().clamp(min=1e-30))
               for n, g in p32["grads"].items()),
           "params_max_abs_err": max(
               float(d[held[n]].max()) if held[n].any() else 0.0
               for n, d in p_diff.items())}
    f32_tol = {"loss_rel": F32_TOL, "grad_norm_rel": F32_TOL,
               "grads_rel_to_tensor_max": F32_TOL,
               "params_max_abs_err": 1e-6}
    n_held = sum(int(m.sum()) for m in held.values())
    n_all = sum(m.numel() for m in held.values())
    left_out = {"share": 1 - n_held / n_all, "params_max_abs_err": max(
        float(d[~held[n]].max()) if (~held[n]).any() else 0.0
        for n, d in p_diff.items())}

    k16, p16 = runs["bfloat16", "kernels"], runs["bfloat16", "plain"]
    ratios = {n: A.error_ratios(k16["grads"][n], p16["grads"][n], g)
              for n, g in p32["grads"].items()}
    bf16 = {"loss_rel": rel(k16["loss"], p16["loss"]),
            "grad_norm_rel": rel(k16["grad_norm"], p16["grad_norm"]),
            "grads_max_ratio": max(r[0] for r in ratios.values()),
            "grads_rms_ratio": max(r[1] for r in ratios.values())}
    bf16_tol = {"loss_rel": BF16_STEP_REL, "grad_norm_rel": BF16_STEP_REL,
                "grads_max_ratio": BF16_RATIO[0],
                "grads_rms_ratio": BF16_RATIO[1]}
    print(tag, json.dumps({
        **info,
        "steps": {f"{dt} {label}": {"loss": r["loss"],
                                    "grad_norm": r["grad_norm"]}
                  for (dt, label), r in runs.items()},
        "float32": f32, "float32_tol": f32_tol,
        "float32_params_left_out": left_out,
        "bfloat16": bf16, "bfloat16_tol": bf16_tol,
        "bfloat16_grad_ratios": ratios}), flush=True)
    for what, got, tol in (("f32", f32, f32_tol), ("bf16", bf16, bf16_tol)):
        bad = {k: v for k, v in got.items() if not v <= tol[k]}
        require(not bad, f"{tag}: {what} step, kernels vs plain: {bad} "
                f"outside {tol}")


def train_parity(cfg, tokens):
    """Phase 7: the trainer's step through the whole-kv kernels against
    the same step through their plain versions (GPT-2 at full width,
    ``cfg.n_layer`` layers), by ``hold_step``; also prints the key
    bias's largest grad: its true grad is 0 (softmax ignores a shift
    common to a row)."""
    import torch
    from ray_tpu_torch.ops import attention as A
    E = cfg.n_embd
    want = {"whole_attention_forward": cfg.n_layer,
            "whole_attention_backward": cfg.n_layer}
    runs = {}
    for dt in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=getattr(torch, dt))
        for label, impl in (("kernels", A.TRAINING_KERNELS),
                            ("plain", A.TRAINING_PLAIN)):
            r = one_step(c, impl, tokens)
            require(r["launches"] == (want if label == "kernels" else {}),
                    f"{dt} {label} step launched {r['launches']}")
            runs[dt, label] = r
    key_grad = max(float(runs["float32", label]["grads"][n][E:2 * E]
                         .abs().max())
                   for label in ("kernels", "plain")
                   for n in runs["float32", label]["grads"]
                   if n.endswith("attn.c_attn.bias"))
    hold_step("train_numerics", runs, {
        "n_layer": cfg.n_layer, "batch": int(tokens.shape[0]),
        "seq": int(tokens.shape[1]), "key_bias_grad_max_abs": key_grad})


def llama_step(cfg, impl, ids) -> dict:
    """One step of the Llama loop (``llama.train_step``) from the seeded
    init with the flash backend on ``impl``: loss, the global norm
    of the grads, the params after the step (f32 only), the grads and
    the launch counts of the step."""
    import torch
    from ray_tpu_torch import kernels
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train import spmd
    model = llama.make_llama(cfg, SEED, impl=impl)      # device: cuda
    opt = llama.adamw(model.parameters())
    kernels.reset_launch_counts()
    loss = float(llama.train_step(model, opt, ids))
    launches = kernels.launch_counts()
    named = list(model.named_parameters())
    keep_params = cfg.dtype == torch.float32
    return {"loss": loss,
            "grad_norm": float(spmd.global_norm([p.grad for _, p in named])),
            "params": ({k: p.detach().clone() for k, p in named}
                       if keep_params else {}),
            "grads": {k: p.grad.detach().clone() for k, p in named},
            "launches": launches}


def llama_parity(cfg, ids):
    """Phase 9: one Llama loop step through the streaming kernels
    against the same step through their plain versions (``TRAINING_PLAIN``
    passed explicitly; Llama-2-7B wide, ``cfg.n_layers`` layers, the same
    seeded init and tokens) in f32 and bf16 compute, by ``hold_step``."""
    import torch
    from ray_tpu_torch.ops import attention as A
    want = {f"flash_attention_{k}": cfg.n_layers
            for k in ("forward", "backward_dkv", "backward_dq")}
    runs = {}
    for dt in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=getattr(torch, dt))
        for label, impl in (("kernels", A.TRAINING_KERNELS),
                            ("plain", A.TRAINING_PLAIN)):
            r = llama_step(c, impl, ids)
            require(r["launches"] == (want if label == "kernels" else {}),
                    f"llama {dt} {label} step launched {r['launches']}")
            runs[dt, label] = r
            torch.cuda.empty_cache()
    hold_step("llama_numerics", runs, {
        "n_layers": cfg.n_layers, "batch": int(ids.shape[0]),
        "seq": int(ids.shape[1])})


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
    # registers and spills (ptxas) and shared memory per CTA of the
    # streaming kernels' tensor-core bodies
    print("kernel_resources", json.dumps(
        [r for r in A.flash_resource_usage()
         if not r["kernel"].endswith("_kernel")]), flush=True)

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
    # training attention (tolerances: see hold_outputs): whole-kv, then
    # streaming; case "a" of each is the shape its training path runs
    whole = {}
    for case in (("a: train shape", 16, 12, 1024, 64, "bfloat16", True),
                 ("b: entry shape", 4, 12, 512, 64, "bfloat16", True),
                 ("c: small f32", 2, 3, 256, 32, "float32", True),
                 ("c: small f32, not causal", 2, 3, 256, 32, "float32",
                  False),
                 ("d: logits past the cap", 2, 2, 256, 64, "float32", True,
                  8.0),
                 ("d: logits past the cap", 2, 2, 256, 64, "bfloat16", True,
                  8.0),
                 ("e: llama-2-7b preset (s 2048, d 128)", 1, 32, 2048, 128,
                  "bfloat16", True)):
        label, B, H, S, D, dtype, causal, *scale = case
        whole[label, dtype] = attention_case("whole", label, B, H, S, S, D,
                                             dtype, causal, flush, *scale)
    flash = {}
    for case in (("a: llama train shape", 2, 32, 4096, 4096, 128,
                  "bfloat16", True),
                 ("b: gpt2 shape", 16, 12, 1024, 1024, 64, "bfloat16", True),
                 ("c: ragged 2064, 16-blocks", 1, 2, 2064, 2064, 32,
                  "float32", True),
                 ("c: sq < sk, top-left", 2, 3, 128, 256, 32, "float32",
                  True),
                 ("c: sq > sk, top-left", 2, 3, 320, 192, 32, "float32",
                  True),
                 ("c: sq < sk, not causal", 2, 3, 128, 256, 32, "float32",
                  False),
                 # the wgmma bodies' edges (d 64, 128): lengths that are not
                 # a multiple of the 128-row CTA tile or of 64, sq != sk
                 ("c: ragged 1040, d 128", 2, 4, 1040, 1040, 128,
                  "bfloat16", True),
                 ("c: ragged 2064, d 64", 1, 2, 2064, 2064, 64, "bfloat16",
                  True),
                 ("c: sq < sk, top-left", 2, 3, 128, 256, 128, "bfloat16",
                  True),
                 ("c: sq > sk, top-left", 2, 3, 320, 192, 64, "bfloat16",
                  True),
                 ("c: sq > sk ragged, not causal", 2, 3, 256, 144, 128,
                  "bfloat16", False),
                 ("c: sq < sk ragged, not causal", 2, 3, 144, 400, 64,
                  "bfloat16", False),
                 ("d: logits past 50", 2, 2, 256, 256, 64, "float32", True,
                  8.0),
                 ("d: logits past 50", 2, 2, 256, 256, 64, "bfloat16", True,
                  8.0),
                 ("d: logits past 50, d 128", 2, 2, 256, 256, 128,
                  "bfloat16", True, 8.0)):
        label, B, H, Sq, Sk, D, dtype, causal, *scale = case
        flash[label, dtype] = attention_case("flash", label, B, H, Sq, Sk,
                                             D, dtype, causal, flush, *scale)
    for cases, letter in ((whole, "d: logits past the cap"),
                          (flash, "d: logits past 50")):
        s_max = min(r["max_scaled_logit"] for (n, _), rows in cases.items()
                    if n.startswith(letter) for r in rows.values())
        require(s_max > 50.0, f"case {letter}: max scaled logit {s_max} "
                "does not pass 50")
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

    del m32, caches, via_kernel, via_plain
    torch.cuda.empty_cache()

    # 6. train GPT-2 small through the port's trainer
    from ray_tpu_torch.train import spmd
    cfg = gpt2.GPT2Config.small()
    batch, seq, warmup, windows, per_window = 16, 1024, 2, 3, 4
    t0 = time.time()
    trainer = spmd.make_causal_lm_trainer(cfg)      # device: cuda
    state = trainer.init(SEED)
    init_s = time.time() - t0
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (batch, seq), dtype=np.int32)
    resident = spmd.put_batch(trainer, {"input_ids": tokens,
                                        "labels": tokens})
    torch.cuda.reset_peak_memory_stats()
    losses, norms = [], []
    for _ in range(warmup):
        state, m = trainer.step(state, resident)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    kernels.reset_launch_counts()
    host_ms, dev_ms = [], []
    for _ in range(windows):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        metrics = [trainer.step(state, resident)[1]
                   for _ in range(per_window)]
        e1.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3 / per_window)
        dev_ms.append(e0.elapsed_time(e1) / per_window)
        losses += [float(m["loss"]) for m in metrics]
        norms += [float(m["grad_norm"]) for m in metrics]
    train_counts = kernels.launch_counts()
    n_steps = windows * per_window
    peak = torch.cuda.max_memory_allocated()
    require(all(math.isfinite(x) for x in losses + norms),
            f"non-finite loss or grad norm: {losses} {norms}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for kname in ("whole_attention_forward", "whole_attention_backward"):
        require(train_counts.get(kname, 0) == cfg.n_layer * n_steps,
                f"{kname} launched {train_counts.get(kname, 0)} times in "
                f"{n_steps} steps of {cfg.n_layer} layers")
    require(set(train_counts) == {"whole_attention_forward",
                                  "whole_attention_backward"},
            f"unexpected kernels on the training path: {train_counts}")
    best = min(host_ms)
    print("train", json.dumps({
        "model": "gpt2-small", "gpt2_batch_per_chip": batch,
        "gpt2_seq_len": seq, "gpt2_step_time_ms": best,
        "gpt2_tokens_per_sec_per_chip": batch * seq / best * 1e3,
        "host_ms_per_step_by_window": host_ms,
        "device_ms_per_step_by_window": dev_ms, "init_s": init_s,
        "losses": losses, "grad_norms": norms,
        "launches": train_counts, "steps_counted": n_steps,
        "max_memory_allocated_bytes": peak, "device": name,
        "nvidia_smi": card}), flush=True)
    print("train_profile", json.dumps(profile_step(
        lambda: trainer.step(state, resident))), flush=True)
    del trainer, state, resident, metrics, m
    torch.cuda.empty_cache()

    # 7. one training step through the kernels against one through
    # their plain versions, in f32 and in bf16 compute
    train_parity(dataclasses.replace(cfg, n_layer=2), tokens[:4])
    torch.cuda.empty_cache()

    # 8. train a Llama-2-7B-wide decoder at 2 x 4096 through the loop
    from ray_tpu_torch.models import llama
    lcfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(),
                               max_seq_len=4096, n_layers=4,
                               attention_backend="flash")
    batch, seq, warmup, windows, per_window = 2, 4096, 2, 3, 2
    t0 = time.time()
    model = llama.make_llama(lcfg, SEED)                # device: cuda
    opt = llama.adamw(model.parameters())
    init_s = time.time() - t0
    n_params = sum(p.numel() for p in model.parameters())
    ids = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, lcfg.vocab_size, (batch, seq)), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    losses = [float(llama.train_step(model, opt, ids)) for _ in range(warmup)]
    kernels.reset_launch_counts()
    host_ms, dev_ms = [], []
    for _ in range(windows):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        step_losses = [llama.train_step(model, opt, ids)
                       for _ in range(per_window)]
        e1.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3 / per_window)
        dev_ms.append(e0.elapsed_time(e1) / per_window)
        losses += [float(x) for x in step_losses]
    llama_counts = kernels.launch_counts()
    n_steps = windows * per_window
    peak = torch.cuda.max_memory_allocated()
    require(all(math.isfinite(x) for x in losses),
            f"llama: non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"llama: loss did not fall: {losses}")
    streaming_names = [f"flash_attention_{k}" for k in
                       ("forward", "backward_dkv", "backward_dq")]
    for kname in streaming_names:
        require(llama_counts.get(kname, 0) == lcfg.n_layers * n_steps,
                f"{kname} launched {llama_counts.get(kname, 0)} times in "
                f"{n_steps} steps of {lcfg.n_layers} layers")
    require(set(llama_counts) == set(streaming_names),
            f"unexpected kernels on the Llama path: {llama_counts}")
    best = min(host_ms)
    print("llama_train", json.dumps({
        "model": "llama-2-7b wide, 4 layers", "params": n_params,
        "batch": batch, "seq_len": seq, "step_time_ms": best,
        "tokens_per_sec": batch * seq / best * 1e3,
        "host_ms_per_step_by_window": host_ms,
        "device_ms_per_step_by_window": dev_ms, "init_s": init_s,
        "losses": losses, "launches": llama_counts,
        "steps_counted": n_steps, "max_memory_allocated_bytes": peak,
        "device": name, "nvidia_smi": card}), flush=True)
    print("llama_train_profile", json.dumps(profile_step(
        lambda: llama.train_step(model, opt, ids))), flush=True)
    del model, opt, step_losses
    torch.cuda.empty_cache()

    # 9. one Llama loop step through the streaming kernels against one
    # through their plain versions, in f32 and in bf16 compute
    llama_parity(dataclasses.replace(lcfg, n_layers=2), ids[:1])
    del ids
    torch.cuda.empty_cache()

    # 10. the port's entry(): the (4, 512) GPT-2-small forward
    from ray_tpu_torch.entry import entry
    fn, args = entry()
    kernels.reset_launch_counts()
    logits = fn(*args)
    torch.cuda.synchronize()
    entry_counts = kernels.launch_counts()
    require(tuple(logits.shape) == (4, 512, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()),
            f"entry logits {tuple(logits.shape)} not finite")
    require(entry_counts == {"whole_attention_forward": cfg.n_layer},
            f"entry forward launched {entry_counts}")
    print("entry", json.dumps({"logits_shape": list(logits.shape),
                               "dtype": str(logits.dtype),
                               "launches": entry_counts}), flush=True)
    del fn, args, logits

    # 11. summary
    def kernel_entry(case, kname, source, line, launches):
        return {"name": kname, "route": "cuda",
                "source": f"ray_tpu_torch/kernels/csrc/{source}",
                "replaces": f"ray_tpu/ops/attention.py:{line}",
                "launches": launches,
                "max_abs_err": case["max_abs_err"], "ms": case["ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"],
                "library_ms": case["library_ms"],
                "library_covers": case.get("library_covers", [])}

    main_whole = whole["a: train shape", "bfloat16"]
    main_flash = flash["a: llama train shape", "bfloat16"]
    summary = {"kernels": [
        kernel_entry({**main_case, "library_ms": None},
                     "paged_attention_decode", "paged_decode.cu", 803,
                     launches),
        *(kernel_entry(main_whole[kname], kname, "whole_attention.cu", line,
                       train_counts[kname])
          for kname, line in (("whole_attention_forward", 86),
                              ("whole_attention_backward", 110))),
        *(kernel_entry(main_flash[kname], kname, "flash_attention.cu", line,
                       llama_counts[kname])
          for kname, line in zip(streaming_names, (303, 410, 469)))]}
    print(card)                  # nvidia-smi's name, power.limit line
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
