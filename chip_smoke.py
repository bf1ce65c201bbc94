#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one H100.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device   — a CUDA card of compute capability 9.0; prints its name and
              power limit (nvidia-smi); TF32 off for the f32 checks.
2. build    — compiles every kernel in ray_tpu_torch/kernels/csrc from
              the checkout, one nvcc per source, in parallel; prints
              the registers, spills and shared memory per CTA of the
              attention kernels' bf16 bodies.
3. kernel   — each kernel's wrapper against its plain PyTorch version on
              the card, at the main paths' shapes and more: max error
              against a stated tolerance, kernel / plain / library time
              (CUDA events, L2 flushed between launches) and the least
              time the card could take. Paged decode at the serving
              shapes; the whole-kv attention forward and backward at
              GPT-2 training's b16 h12 s1024 d64 bf16, at the entry
              shape b4 h12 s512, at Llama-2-7B's preset shape b1 h32
              s2048 d128, at a small f32 shape, at shapes whose scaled
              logits pass the 50 cap (f32 and bf16, d 64 and 128) and
              at the edges of the wgmma backward in bf16 (s 192 and
              320, not multiples of 128; not causal); the
              streaming forward, dkv and dq kernels at Llama-2-7B
              training's b2 h32 s4096 d128 bf16, at GPT-2's shape, at
              small f32 shapes (a ragged 2064 = 16 * 129, sq != sk with
              the top-left causal mask, not causal), at the same edges
              in bf16 for the wgmma backward (d 64 and 128; 1040 and
              2064, not multiples of 64 or 128) and past the cap; with
              each attention case, the delta pass that both training
              backwards run (attention_delta) on its o and do. Paged
              decode also at Llama-2-7B serving's shape (B 16, H = Hkv =
              32, D 128, NB 128 pages of 16, bf16), with its
              registers and shared memory. In bf16 each kernel and its plain version are both held to
              the function in f64 (attention_case, hold_outputs).
              SDPA's backward is timed as device time (a CUDA graph's
              replays; sdpa_backward_ms).
4. serve    — GPT-2 small at full width and depth (random weights from a
              seed) behind the port's LLMServer: 16 concurrent streams of
              64 greedy tokens. Launch counts are zeroed just before and
              read just after: the paged-decode kernel must account for
              every layer of every decode step. Then each prompt alone
              (phase 25's reference).
5. numerics — the same GPT-2 cast to f32: one batched decode step
              through the kernel against the same step with the plain
              version passed explicitly, and against the full forward.
5b. llama serve — Llama-2-7B at its published widths and depth (32
              layers, dim 4096, 32 heads of d 128, ffn 11008, vocab
              32000; random weights from a seed; bf16 weights, the f32
              head) behind LLMServer: a warm-up request, then 16
              concurrent streams of 64 greedy tokens (prompts 64-768),
              max_seq_len 2048, 1,025 pages of 16 tokens. The
              paged-decode kernel must take all 32 layers of every
              decode step. Prints tokens/s, TTFT, ITL, decode steps,
              launches, weight and pool bytes and peak memory; then
              the 16 prompts prefilled as one batch (time, peak) and
              decode steps of 16 rows (host time, one profiled by
              kernel group, its idle share).
5c. llama serve numerics — the same widths at 2 layers in f32, with 32
              and with 8 kv heads: 8 ragged prompts (37-700 tokens)
              through the adapter's paged prefill, then one decode step
              through the kernel against the same step with the plain
              version passed explicitly and against the full forward
              (phase 5's tolerance); then speculative decoding with that
              model as the target and a Llama draft of the same seed
              (every proposal accepted) and of another (rejected): 4
              prompts x 16 tokens, token-identical to spec_k = 0.
6. train    — ray_tpu_torch.bench.gpt2_loop: make_causal_lm_trainer(
              GPT2Config.small()) on the card, batch 16 x 1024 of
              seeded tokens: warm-up steps, then timed windows with the
              launch counts zeroed before and read after (each whole-kv
              kernel and the delta pass exactly n_layer times a step);
              the loss is finite and falls on the repeated batch.
              Prints bench.py's gpt2_* keys and peak memory, then one
              profiled step's device time by kernel group.
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
              streaming kernel and the delta pass exactly n_layers times
              a step, no whole-kv launch); the loss is finite and falls. Prints
              step time, tokens/s, peak memory and one profiled step.
9. llama numerics — the same model at 2 layers, batch 1 x 4096: one
              loop step through the streaming kernels against one
              through their plain versions, in f32 and in bf16
              (llama_parity, the rules of train_parity).
10. entry   — ray_tpu_torch.entry.entry() on the card: logits
              (4, 512, 50257), finite, one forward kernel per layer.
11. resnet  — (a) one step of a narrow ResNet (bottleneck, one block
              per stage, 8 filters, 32 x 32, batch 4, f32, TF32 off)
              on the card against the same step on the CPU: loss,
              logits, params and batch stats (resnet_parity), every
              conv input channels_last; (b) ResNet-50 at its published
              widths, batch 256 x 224 x 224, bf16 compute, through
              ray_tpu_torch.bench.resnet_loop: a finite loss, no launch
              of the port's kernels; prints bench.py's keys (step time,
              img/s, FLOPs and their source, mfu), peak memory and the
              card; (c) one profiled step by kernel group
              (RESNET_PROFILE_GROUPS) and its idle share.
12. mesh    — a NCCL process group of one rank, formed in this process
              (file store): the mesh route of both trainers (a torch
              DeviceMesh over the group; params and grads through the
              collectives; ResNet's batch norm over the global batch).
              (c) first: a narrow f32 step of each trainer (GPT-2 at
              full width, 2 layers, 4 x 1024; the narrow ResNet of
              phase 11a) on the route without a group, then on the mesh
              route: GPT-2's loss and grad_norm within MESH_REL
              relative and its params within 1e-6 where the step's
              |grad| passes PARAM_MASK; the ResNet by phase 11a's
              rule (RESNET_LOSS_REL, RESNET_TOL) on logits, params and
              batch stats. (a) bench.gpt2_loop on the mesh route (GPT-2
              small, 16 x 1024 bf16): each whole-kv kernel and the delta
              pass exactly n_layer times a step, collectives counted;
              step time and tokens/s beside phase 6's; one profiled
              step. A 2-layer GPT-2 at full width, 2 x 4096,
              exact=True: one step launches each streaming kernel and
              the delta pass once per layer, no whole-kv kernel. (b) bench.resnet_loop on the mesh route
              (ResNet-50, 256 x 224 x 224 bf16): one batch-norm
              all_gather per norm layer a step (the global statistics),
              no kernel of the port; step time and img/s beside phase
              11's; one profiled step by RESNET_PROFILE_GROUPS. The group
              is destroyed at the end.
14. parallel — sp, pp and ep (run before the summary). The card is one
              H100, so every multi-rank path is held on the CPU (gloo
              ranks, tests/test_torch_{ring_attention,pipeline,moe}.py
              and the dry run); here: (a) the ring's block schedule at
              Llama-2-7B's attention widths (b1, h32, d128, bf16) over
              sp = 4 x 4,096 = 16,384 tokens, every rank's forward and
              backward in this process (ring_attention.simulated_ring:
              the ring's own per-block steps and merge, the transport
              replaced), 10 launches of each streaming kernel and one
              delta pass a rank; concatenated, o, lse, dq, dk and dv are
              held against the streaming kernels called once on the
              whole sequence (RING_RATIO against the f64 function);
              each rank's device time beside a quarter of the whole
              sequence's; at a small shape the ring through the kernels
              against the ring through their plain versions (BF16_RATIO
              against the f64 function). (b) make_causal_lm_trainer on
              GPT-2 small with attention_backend="ring" on a NCCL group
              of one rank (sp = 1: one causal block a layer), 16 x
              1024: one step within MESH_REL of the exact=True route's,
              then bench.gpt2_loop with it: each streaming kernel and
              the delta pass once a layer a step, no whole-kv launch;
              step time beside phase 6's. (c) make_pipelined_lm_trainer
              on GPT-2 small at pp = 1 on the same group, M = 4
              microbatches of 4 x 1024 bf16 (phase 6's tokens a step):
              the step's loss equals eval_loss before it (MESH_REL),
              the loss falls; a step launches the whole-kv forward
              2 n_layer M times (the stage's forward, then again under
              remat in the backward), the backward and the delta pass
              n_layer M times; step time, tokens/s and peak memory
              beside phase 6's; one profiled step (informational, after
              the counts). (d) the MoE step of the dry run's phase
              4 (4 experts, d 16, d_ff 32, 16 tokens) in f32 on the card
              against the same step on the CPU (MOE_RTOL, MOE_ATOL).
15. ppo atari — RLlib's local PPO path (ray_tpu_torch.rllib, run before
              the summary): (b) first, the card against the port's own
              CPU run: one PPOPolicy.learn_on_batch on a fixed f32 MLP
              batch (stats and params within PPO_F32 of their scale,
              TF32 off), and AtariCNN's bf16 forward at 84 x 84 x 4 on
              the card against an f64 CPU forward of the same params,
              its (max, rms) error at most ATARI_BF16_RATIO times the
              CPU bf16 forward's; (a) bench.ppo_loop: PPO on
              PixelCatcher-v0 at the Atari widths (84 x 84 x 4 frames
              through FrameStackConnector(4), the Nature CNN, 50 envs x
              100 steps = 5,000 a batch, minibatch 500 x 10 epochs, the
              atari-ppo.yaml settings, seed 0): one warm-up iteration
              and 3 timed ones; finite losses, weights that moved;
              prints env steps/s, the sample / postprocess / learn
              split, peak memory and one learn phase profiled by kernel
              group (PPO_PROFILE_GROUPS) with its idle share; (c) the
              launch counts, zeroed at the phase's start and read at
              its end, are empty: the RL path launches none of the
              port's kernels.
16. rl algorithms — RLlib's V-trace and value-based local paths (run
              before the summary): (b) first, the card against the
              port's own CPU run, f32, TF32 off: one IMPALAPolicy and
              one APPOPolicy learn_on_batch on a fixed MLP batch with
              cuts and terminals, two DQNPolicy learn_on_batch with
              double-Q and weights (per-sample td_errors included),
              stats and params within PPO_F32 of their scale; vtrace on
              a 500-row sequence against the f64 row loop
              (vtrace_f64), with the scan's device time beside a row
              loop's on the card; 4 batches through a LearnerThread on
              the card while the main thread reads weights under its lock,
              against learn_on_batch inline on a second policy, within
              PPO_F32, check_error() clean; (a) bench.impala_loop:
              IMPALA on PixelCatcher-v0 at 84 x 84 x 4, 10 envs x 50
              steps = 500 a learn step (atari-impala.yaml's fragment
              and batch), one warm-up and 10 timed iterations, one
              learn phase profiled (PPO_PROFILE_GROUPS); one APPO
              iteration through the same config; bench.dqn_loop: DQN
              at the same widths, 8 envs x 4 steps, batch 32, double-Q,
              a uniform buffer of 50,000 rows, the buffer filled to
              1,000 rows, one warm-up and 200 timed iterations, one
              learn phase of 10 updates profiled; finite losses,
              weights that moved, DQN's buffer grown, epsilon fallen,
              target synced; (c) the launch counts, zeroed at the
              phase's start and read at its end, are empty.
17. continuous and offline — RLlib's SAC, DDPG/TD3, offline JSON IO,
              BC/MARWIL, CQL and CRR (run before the summary): (b)
              first, the card against the port's own CPU run, f32, TF32
              off, at Pendulum's spaces with the 256 x 256 nets and
              batch 256, numpy noise given to both: one SAC update, one
              DDPG and two TD3 learn steps (the delayed actor included),
              one CQL update in each phase (_bc_weight 1 and 0), one CRR
              update per weight_type, one MARWIL update; stats and params
              within PPO_F32 of their scale, the SAC family's pi head
              scaled by 1/4 off tanh's saturation (sac_own_init prints
              one SAC update at its own init); (a) bench.sac_loop: SAC on
              Pendulum-v1 at pendulum-sac.yaml's settings (256 x 256,
              batch 256, fragments of 1, 256 steps before learning, a
              100,000-row buffer), 1,000 timed iterations;
              bench.ddpg_loop("TD3"): TD3Config's defaults, 1,000;
              bench.offline_loop for CQL (25 timed iterations: past its
              200 BC steps), CRR, MARWIL and BC (3 each) on a
              100,000-row Pendulum set (500 episodes x 200 steps of the
              noisy PD law, written by JsonWriter once and read back by
              each); SAC's, TD3's and CQL's learn phases profiled
              (PPO_PROFILE_GROUPS); finite losses, weights that moved,
              buffers that grew, actions inside the Box; (c) the launch
              counts, zeroed at the phase's start and read at its end,
              are empty.
18. local algorithms — RLlib's LocalAlgorithm with its algorithms
              (run before the summary): (b) first, the card against the
              port's own CPU run, f32, TF32 off, at the JAX configs'
              default widths, nets built from one seed: one R2D2 update
              (32 sequences of 20, LSTM 64, burn-in 4, padded and
              terminal rows), one DT update (64 windows of 24 tokens,
              width 64, 4 heads, 2 layers, drawn from the offline
              CartPole set), one SlateQ update (batch 128 from its
              replay); stats and params within PPO_F32 of their scale;
              (a) bench.r2d2_loop: R2D2 on CartPole-v1 at R2D2Config's
              defaults, 40 timed iterations; bench.slateq_loop: SlateQ
              at SlateQConfig's defaults (20 docs, slates of 3, 6
              topics, batch 128), 20; bench.dt_loop: DT at DTConfig's
              defaults on the offline CartPole set (120 episodes capped
              at 120 steps of the JAX DT fixture's noisy heuristic,
              written by JsonWriter and read back), 10 iterations of 20
              learn steps; bench.bandit_loop: LinUCB and LinTS on the
              host; R2D2's and SlateQ's learn phases and one DT
              iteration profiled (PPO_PROFILE_GROUPS); finite losses,
              weights that moved, replays that grew, epsilon that fell,
              targets synced at their period (equal to the online net
              right after); (c) the launch counts, zeroed at the
              phase's start and read at its end, are empty.
19. multi-agent and meta — RLlib's cooperative multi-agent and
              meta-learning algorithms (run before the summary): (b)
              first, the card against the port's own CPU run, f32, TF32
              off, at the JAX configs' default widths, nets built from
              one seed: one QMIX update (64 rows of CoopCartPole, 2
              agents), one MADDPG update (128 rows of
              MultiAgentTarget1D, 2 agents, actors and critics stacked),
              one MAML meta-update (10 tasks x 10 episodes x 20 steps,
              second order), one MBMPO ensemble update (4 x 256
              bootstrap rows) and one imagination (16 episodes x 20
              steps) with fed noise; stats and grads within PPO_F32 of
              their scale, params by phase 18b's rule (hold_update);
              (a) bench.qmix_loop (QMixConfig's defaults, 100 timed
              iterations), bench.maddpg_loop (MADDPGConfig's, 50),
              bench.maml_loop (MAMLConfig's: 4,000 env steps and one
              meta-update an iteration, 5), bench.mbmpo_loop
              (MBMPOConfig's: K = 4, 60 model updates, 16 real episodes,
              4 x 2 imaginations, one meta-update an iteration, 10),
              each with one learn phase profiled (PPO_PROFILE_GROUPS):
              finite losses, weights that moved, replays that grew,
              QMIX's epsilon falling and its target synced at its
              period, MADDPG's targets moved by Polyak, MBMPO's trained
              ensemble below the untrained one's loss on held rows of
              the buffer, and the buffer growing; (c) the launch
              counts, zeroed at the phase's start and read at its end,
              are empty.
20. model-based, planning and multi-agent — RLlib's Dreamer, AlphaZero,
              AlphaStar and the multi-agent worker with multi-agent PPO
              (run before the summary): (b) first, the card against the
              port's own CPU run, f32, TF32 off, nets built from one
              seed: one Dreamer update at DreamerConfig's defaults (24 x
              16 sequences a CPU Dreamer collected on Pendulum, horizon
              10, fed noise), one AlphaZero update of 256 rows of CPU
              self-play (TicTacToe; and Connect4's 84-wide obs), one
              AlphaStar update on one game's trajectory, and the first
              minibatch step (128 rows) of each policy's learn phase of
              multi-agent PPO on one CPU sample (512 env steps of
              MultiAgentCartPole, 2 policies of 256 x 256); each by
              phase 18b's rule (hold_update); (a) bench.dreamer_loop
              (DreamerConfig's defaults: prefill 1,000, then 200 env
              steps + 20 updates an iteration, 5 timed),
              bench.alphazero_loop (24 games x 25 sims, 8 x 256 SGD, 3
              timed), bench.alphastar_loop (64 matches an iteration, 10
              timed, the 10th snapshotting main), bench.ma_ppo_loop
              (512 / 128 x 6, 2 policies, 5 timed), each with one learn
              phase profiled (PPO_PROFILE_GROUPS): finite losses,
              weights that moved, the widths, Dreamer's reconstruction
              loss on a held batch falling across the timed window,
              AlphaStar's snapshot inside the window and apart from
              main after the next update, both policies in multi-agent
              PPO's learner info; (c) the launch counts, zeroed at the
              phase's start and read at its end, are empty.
21. checkpoints and disaggregation — (a) GPT-2 small at 16 x 1024
              through make_causal_lm_trainer: 2 steps, an async save
              (AsyncCheckpointer over a CheckpointManager), 2 steps
              while it writes; a fresh init from another seed restored
              by restore_spmd_state runs the same 2 batches: losses and
              grad norms within CKPT_RESUME_REL (0: bit-equal) of the
              uninterrupted run's, params and moments byte-equal to the
              saved state; 3 saves leave 2 committed, verified steps;
              12 launches of each whole-kv kernel a step; then
              bench.ckpt_loop (sync against async saves between real
              steps). (b) bench.disagg_loop on phase 4's prompts and
              weights: two LLMServers, __llm_prefill__ then
              __llm_adopt__; each prompt alone gives the unified
              server's tokens exactly; concurrently, each stream equals
              phase 4's or leaves it at a near-tie (NEAR_TIE_FACTOR),
              every handoff adopted, no decode step on the prefill
              server and the paged-decode kernel on every layer of the
              decode server's every step, both pools back at 0 used
              pages, a frame with a flipped byte re-prefilled (adopted
              False) to the tokens of its prompt alone.
22. runtime — ray_tpu_torch.init(num_cpus=4) on this machine:
              cluster_resources()["GPU"] == 1, found without torch (the
              GCS's and the raylet's /proc/<pid>/maps hold no libtorch
              or libcuda); a num_gpus=1 actor trains phase 6's GPT-2
              small for RUNTIME_STEPS steps on phase 6's batch and seed:
              losses and grad norms bit-equal to the same steps run in
              this process, 12 launches a step of each whole-kv kernel
              and of the delta pass, get_gpu_ids() == [0] and
              CUDA_VISIBLE_DEVICES == "0", the kernel libraries loaded,
              not rebuilt; a second num_gpus=1 actor (an LLMServer on
              phase 4's weights) stays queued while the first holds the
              GPU, starts after kill() of the first, and serves 4 of
              phase 4's prompts, each alone, to the tokens of this
              process's server on the same prompts alone, through the
              paged-decode kernel; a num_gpus=0 task sees
              CUDA_VISIBLE_DEVICES "" and no CUDA. Host numbers: put
              and get of a 256 MB CPU tensor and a 16 MB bf16 CUDA
              tensor (bytes equal), the no-op task and actor-call round
              trips, the GPU worker's start.
23. framework — the headline bench's framework path,
              ray_tpu_torch.bench.framework_main(): init(num_cpus=4,
              num_gpus=1), 1,024 uint8 224 x 224 images from
              default_rng(0) through data.from_items(parallelism=8), and
              DataParallelTrainer(ScalingConfig(num_workers=1,
              use_gpu=True)).fit(): in the GPU-granted train worker
              (get_gpu_ids() == [0]) ResNet-50 at 256 x 224 x 224 bf16 on
              the shard's batches from iter_device_batches (pinned
              copies on a side stream, 4 batches cached and cycled),
              then GPT-2 small (phase 6's loop). Checks: no gpt2_error
              and the gpt2_* keys; the first device batch's image bytes
              (sha256) and labels equal to the driver's first 256 rows,
              uint8 images, on the card; finite ResNet losses and no
              launch of the port's kernels in the ResNet loop; 12
              launches a step of each whole-kv kernel and of the delta
              pass in the worker's GPT-2 steps; the worker's GPT-2
              losses and grad norms bit-equal to phase 6's. Prints
              img/s, framework_vs_raw against phase 11, the ingest's
              seconds, the worker's start, fit() to the first batch and
              to the first step.
24. rl remote — RLlib's runtime half (ray_tpu_torch.rllib on
              init(num_cpus=REMOTE_CPUS), one GPU): (a) a LearnerGroup
              learner actor on the card (num_gpus=1) against a local
              CPU learner from the same seed, REMOTE_LEARNER_UPDATES
              PPO updates (MLP 256 x 256, 512-row batches) held by
              hold_update; a PPO WorkerSet whose learner is on the card
              and whose 2 remote rollout workers are on the CPU: after
              sync_weights their weights are byte-equal to the
              learner's host copy; (b) bench.ppo_remote_loop: PPO-Atari
              at atari-ppo.yaml's 10 remote workers x 5 envs (one torch
              thread each), the learner on the card, one warm-up and 3
              timed iterations, one learn phase profiled
              (PPO_PROFILE_GROUPS); env steps/s beside phase 15's
              one-local-worker form (remote_vs_local), the timers'
              split, the sampling share, the learn phase's idle share,
              each actor's start; the workers hold the learner's
              weights byte for byte after the last sync; (c)
              bench.impala_remote_loop: IMPALA-Atari with the async
              learner thread fed by remote workers of 5 envs x 50 steps
              (atari-impala.yaml's 32 cut to the machine's CPUs less 2),
              5 timed iterations: the learner queue's depth after each,
              the learner thread's steps, rows and empty-queue wait,
              env steps/s against phase 16's; (d)
              bench.remote_algo_loops: DDPPO, Ape-X DQN, Ape-X DDPG,
              A3C, ES, ARS and PPO with an evaluation WorkerSet (each
              with 2 remote workers and the learner on the card, all
              built first so their actors start together, 3 timed
              iterations each): weights that moved, the remote workers
              holding the learner's weights after a sync (ES: the
              policy holding theta), the steps and learner counts each
              config implies; (e) the launch counts, zeroed at the
              phase's start and read at its end, are empty.
25. serve on the runtime — ray_tpu_torch.bench.serve_loop on phase
              4's prompts: init(num_cpus=4), serve.start with the HTTP
              proxy on a free port, serve.run of an LLMServer (GPT-2
              small, phase 4's seed and engine) with
              ray_actor_options={"num_gpus": 1}. Checks: the replica
              holds get_gpu_ids() == [0] and CUDA_VISIBLE_DEVICES "0",
              on cuda, and loaded phase 2's kernel libraries, none
              rebuilt (same paths, same mtimes); each prompt alone
              through the handle gives phase 4's tokens for it alone
              exactly; 16 concurrent SSE streams of 64 greedy tokens
              through the proxy: each equals phase 4's stream or leaves
              it at a near-tie (NEAR_TIE_FACTOR), each first event
              before its [DONE]; a unary JSON POST gives the handle's
              tokens; the replica's paged-decode launches (zeroed
              before the streams, read from the replica after) are its
              layers times its decode steps; its pool ends at 0 used
              pages; after serve.shutdown() a num_gpus=1 task starts.
              Prints tokens/s, TTFT and ITL p50/p99 at the client
              beside phase 4's in-process numbers (serve_vs_inprocess),
              the replica's start, decode steps and launches. The
              router's two-hop disaggregation is bypassed (it needs
              two GPU-granted replicas; this machine has one GPU).
13. summary — nvidia-smi's card line, the kernels line (each kernel's
              launches by the path that counted them: phases 4, 5b, 6,
              8, 12, 14, 21, 22, 23 and 25; paged decode's entry also
              carries its Llama serve case, the streaming kernels' the
              ring's), then the device line, last.

Exits non-zero without printing a result when CUDA is absent or when
the repository's package is not beside this script.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # f32 outside the tensor cores
SEED = 0
# profile_step's kernel groups, by substrings of the kernel's name: the
# port's attention kernels and their delta pass, then f32 products (SIMT sgemm: Llama's f32
# LM head, TF32 off), then the other matrix products (cuBLAS/CUTLASS)
PROFILE_GROUPS = (
    ("whole_kv_attention", ("whole_fwd", "whole_bwd")),
    ("streaming_attention", ("flash_fwd", "flash_dkv", "flash_dq")),
    ("attention_delta", ("attention_delta",)),
    ("matmul_f32", ("sgemm", "f32f32_f32f32")),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas", "sm90_")))
# a serving decode step's groups, in the same way: the paged-decode
# kernel (split and merge), the f32 head's product, the bf16 products
SERVE_PROFILE_GROUPS = (
    ("paged_decode", ("paged_decode",)),
    ("matmul_f32", ("sgemm", "f32f32_f32f32")),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas", "sm90_")))
# the ResNet step's groups, in the same way: batch norm (PyTorch's
# channels_last kernels, forward and backward), cuDNN's forward and
# backward convs, cuDNN's other conv kernels (1x1 convs it runs as bf16
# GEMMs through cuBLASLt or CUTLASS, either direction, and its input
# padding), max-pool and the head's mean, the optimizer's foreach
# kernels, the f32 head (the step's only f32 product), then elementwise
# ops (ReLU and its backward, the residual adds, pads, casts, fills)
RESNET_PROFILE_GROUPS = (
    ("batch_norm", ("batch_norm",)),
    ("conv_fwd", ("fprop",)),
    ("conv_bwd", ("dgrad", "wgrad")),
    ("conv_gemm", ("nvjet", "gemm_bf16", "nhwcaddpadding")),
    ("pooling", ("max_pool", "meanops")),
    ("optimizer", ("multi_tensor_apply",)),
    ("head_f32", ("f32f32",)),
    ("elementwise_relu", ("elementwise", "memset")))
# the narrow ResNet step on the card against the same step on the CPU
# (resnet_parity, f32, TF32 off): the loss within RESNET_LOSS_REL
# relative; logits, params and batch stats within RESNET_TOL of each
# tensor's scale (1 + max |cpu|): cuDNN's and oneDNN's convs and the
# two batch-norm reductions sum in other orders. Measured on an H100
# (PERF.md): loss equal, worst tensor 5.8e-7.
RESNET_LOSS_REL = 1e-5
RESNET_TOL = 1e-5
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
# phase 12c: GPT-2's f32 step on the mesh route (world size 1) against
# the route without a group: loss and grad_norm within MESH_REL relative
MESH_REL = 1e-6
# phase 14a: the ring's bf16 outputs against the whole-sequence streaming
# kernels', each measured against the f64 function: the ring's max and
# rms error at most RING_RATIO times the whole sequence's. The ring
# rounds each block's o and each rank's dk, dv and dq parts to bf16
# before it sums them in f32; a CPU rehearsal with the plain versions (b1,
# h2 and h4, 4 ranks of 512 and 256, d 128 and 64) gave ratios up to
# 1.70 (max) and 1.23 (rms), so the rms bound is above BF16_RATIO's.
RING_RATIO = (3.0, 1.5)
# phase 14d: the f32 MoE step on the card against the CPU, at
# tests/test_moe.py's tolerances
MOE_RTOL, MOE_ATOL = 1e-4, 1e-5
# phase 15b: one f32 PPO learn_on_batch on the card against the CPU:
# stats and params within PPO_F32 * (1 + max |cpu|) (the CPU tests'
# bound against JAX, tests/test_torch_rllib.py); the bf16 AtariCNN
# forward's (max, rms) error against the f64 CPU forward at most
# ATARI_BF16_RATIO times the CPU bf16 forward's (cuDNN adds the conv
# bias to the rounded bf16 output, oneDNN before rounding, so the rms
# bound is above BF16_RATIO's)
PPO_F32 = 1e-5
# phase 21a: the two GPT-2 small steps after a restore against the same
# two steps of the uninterrupted run: loss and grad_norm within
# CKPT_RESUME_REL relative. 0 asks for bit-equality: the restored
# params, moments and step are the saved bytes, and every kernel of the
# step is deterministic (no atomics; csrc/whole_attention.cu:42).
CKPT_RESUME_REL = 0.0
# phase 21b: a concurrent disaggregated stream may leave phase 4's where
# the two runs' batches round differently (cuBLAS picks its bf16 GEMM
# kernels by the batch's rows; the two runs batch differently). Where one
# does, at its first differing token the f32 model's logit margin
# between the two tokens must be within NEAR_TIE_FACTOR times the bf16
# model's largest logit error there: each run's bf16 logits sit within
# that error of the f32 ones, so two of them can swap two tokens only
# that close. Each prompt alone (one row in every step of both runs)
# must give the same tokens exactly.
NEAR_TIE_FACTOR = 2.0
# phase 22: GPT-2 small steps in a GPU-granted actor against the same
# steps in this process (bit-equal: same kernels, same shapes, same
# bytes in), and how many of phase 4's prompts the second actor serves
RUNTIME_STEPS = 3
RUNTIME_PROMPTS = 4
ATARI_BF16_RATIO = (3.0, 1.5)
# phase 24: the cluster's CPUs (atari-ppo.yaml's 10 rollout workers hold
# one each; 24d's loops, built together, 12) and the remote learner's
# updates
# against the CPU learner's (PPO's MLP at 256 x 256, a 512-row batch)
REMOTE_CPUS = 12
REMOTE_LEARNER_UPDATES = 3
# the PPO learn phase's groups: cuDNN's convs, the products (the
# 7,744 x 512 Dense and the heads), Adam's foreach kernels, the
# host-to-device copies of each minibatch, then the rest
PPO_PROFILE_GROUPS = (
    ("conv_fwd", ("fprop", "conv2d", "implicit_convolve")),
    ("conv_bwd", ("dgrad", "wgrad")),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas", "sm90_")),
    ("optimizer", ("multi_tensor_apply",)),
    ("copy_h2d", ("memcpy htod",)))


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
    L2 flush, timed with CUDA events around the launch alone. The flush
    must outlast ``fn``'s host work (the events then hold the device
    time alone)."""
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
    """Kernel vs plain version on one shape; returns the measurements.
    Rows of length > 0 are held within ``tol`` of the plain version and,
    in bf16, also by hold_outputs' ratio rule against the function in
    f64 (``paged_attention_f64``: both round p and the output, at other
    points); rows of length 0 (batch padding) must be zeros."""
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
    live = lens > 0
    err = float((out[live].float() - ref[live].float()).abs().max())
    require(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
    require(err <= tol, f"{name}: max error {err} > {tol}")
    require(not out[~live].any(), f"{name}: a length-0 row is not zeros")
    ratio = None
    if dtype != "float32":
        ratio = A.error_ratios(out[live], ref[live], A.paged_attention_f64(
            q, k, v, tables, lens)[live])
        require(ratio[0] <= BF16_RATIO[0] and ratio[1] <= BF16_RATIO[1],
                f"{name}: error against the f64 function {ratio} times "
                f"the plain version's, over {BF16_RATIO}")
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
           "f64_ratios": ratio, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes}
    print("kernel", json.dumps(res))
    return res


def hold_outputs(name, dtype, outs, refs) -> dict:
    """Holds each kernel output to its plain version's, ``outs`` = {name:
    (kernel, plain)} in the order o, lse, dq, dk, dv, delta:

    f32 outputs (all of them for f32 inputs; lse and delta for bf16
          inputs, which neither side rounds to bf16):
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


def held_outputs(pairs, refs, names, ratio=BF16_RATIO):
    """``hold_outputs``'s rule on [(kernel, plain), ...]: (held, bad),
    held[name] = the f32 measure (a float) or the bf16 ratios (max,
    rms); bad = the names outside F32_TOL or ``ratio``. ``refs()`` is
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
            ok = held[n][0] <= ratio[0] and held[n][1] <= ratio[1]
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
# delta), products of 2 * D flops per causal pair in the inputs' dtype,
# and 2 * D f32 flops per row
ATTENTION_WORK = {   # kernel: (q-shaped, k-shaped, f32 rows, products,
    #                           row passes)
    # q, k, v in, o and lse out; s = q.k^T, e.v
    "whole_attention_forward": (2, 2, 1, 2, 0),
    # q, k, v, o, do, lse in (delta inside), dq, dk, dv out; s, dp, dq,
    # dk, dv (delta's row pass left out: under 0.1% of the products)
    "whole_attention_backward": (5, 3, 1, 5, 0),
    "flash_attention_forward": (2, 2, 1, 2, 0),
    # q, k, v, do, lse, delta in, dk, dv out; s, dp, dv, dk
    "flash_attention_backward_dkv": (2, 4, 2, 4, 0),
    # the same in, dq out; s, dp, dq
    "flash_attention_backward_dq": (3, 2, 2, 3, 0),
    # o, do in, delta out; o . do per row
    "attention_delta": (2, 0, 1, 0, 1)}


def attention_bound(kname, B, H, Sq, Sk, D, dtype, causal):
    """(bound_ms, bound_by, bytes, flops) of one attention wrapper's
    function (ATTENTION_WORK), causal pairs only."""
    n_q, n_k, n_rows, products, row_passes = ATTENTION_WORK[kname]
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = ((n_q * Sq + n_k * Sk) * D * elt + n_rows * Sq * 4) * B * H
    flops = 2 * D * products * B * H * causal_pairs(Sq, Sk, causal)
    row_flops = 2 * D * row_passes * B * H * Sq
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_FLOPS[dtype]
             + row_flops / PEAK_FLOPS["float32"]) * 1e3
    flops += row_flops
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
    one backward launch after the delta pass; Sq = Sk) or "flash" (the
    streaming forward and the backward as two launches, dkv and dq;
    plain versions at the blocks flash_attention fits to the shape),
    and the delta pass both backwards run (``attention_delta``). Each of
    o, lse, dq, dk, dv and delta is held by ``hold_outputs`` (bf16
    yardsticks: ``{path}_attention_*_f64``, the streaming ones a few
    heads at a time). The backwards and the delta pass start from the
    plain forward's o and lse (the streaming ones from the plain
    delta), so each kernel is held on its own. Returns {kernel name:
    its measurements}. The library yardstick is SDPA: its forward for
    the forward, its backward (dq, dk and dv in one call, device time:
    ``sdpa_backward_ms``) for the backward, and for the streaming pair
    dkv + dq together (``library_covers`` on both rows); the delta pass
    has none."""
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
        bwd_args = (q, k, v, do, rlse, A.attention_delta_reference(ro, do))
    parts = {f"{path}_attention_forward": (fwd_args, ("o", "lse")),
             **{kname: (bwd_args, names) for kname, names in bwd.items()},
             "attention_delta": ((ro, do), ("delta",))}

    def run(kname, plain=False):
        args, _ = parts[kname]
        fn = getattr(A, kname + ("_reference" if plain else ""))
        kw = {} if kname == "attention_delta" else {"causal": causal}
        return lambda: fn(*args, **kw)

    kernel_outs = {kname: run(kname)() for kname in parts}
    torch.cuda.synchronize()
    outs = {}
    for kname, (_, names) in parts.items():
        got, want = kernel_outs[kname], run(kname, plain=True)()
        got, want = ((got,), (want,)) if len(names) == 1 else (got, want)
        outs.update(zip(names, zip(got, want)))
    outs = {n: outs[n] for n in ("o", "lse", "dq", "dk", "dv", "delta")}

    def refs():
        f64 = getattr(A, f"{path}_attention_forward_f64"), getattr(
            A, f"{path}_attention_backward_f64")
        return (f64[0](q, k, v, causal=causal)
                + f64[1](q, k, v, ro, rlse, do, causal=causal)
                + ((ro.double() * do.double()).sum(-1),))
    abs_err = hold_outputs(name, dtype, outs, refs)
    del outs, kernel_outs

    # the library calls, timed here and never called by the port
    lib_f = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, scale=1.0), flush)
    lib_b, lib_b_host = sdpa_backward_ms(q, k, v, do, causal, flush)
    library = {f"{path}_attention_forward": {
                   "library_ms": lib_f,
                   "library_covers": [f"{path}_attention_forward"]},
               **{kname: {"library_ms": lib_b, "library_covers": list(bwd),
                          "library_ms_autograd": lib_b_host}
                  for kname in bwd},
               "attention_delta": {"library_ms": None, "library_covers": []}}
    res = {}
    for kname, (_, names) in parts.items():
        bound, by, nbytes, flops = attention_bound(kname, B, H, Sq, Sk, D,
                                                   dtype, causal)
        r = {"case": name, "kernel": kname, "shape": [B, H, Sq, Sk, D],
             "dtype": dtype, "causal": causal,
             "max_scaled_logit": s_max,
             "max_abs_err": max(abs_err[n] for n in names),
             "ms": time_ms(run(kname), flush),
             "plain_ms": time_ms(run(kname, plain=True), flush, iters=3),
             **library[kname],
             "bound_ms": bound, "bound_by": by,
             "bytes": nbytes, "flops": flops}
        print("kernel", json.dumps(r), flush=True)
        res[kname] = r
    if len(bwd) > 1:
        print("backward_pair", json.dumps({
            "case": name, "kernels_ms": sum(res[k]["ms"] for k in bwd),
            "sdpa_backward_ms": lib_b,
            "sdpa_backward_autograd_ms": lib_b_host}), flush=True)
    return res


def sdpa_backward_ms(q, k, v, do, causal, flush):
    """SDPA's backward (dq, dk and dv in one ``torch.autograd.grad``
    call) timed two ways, by ``time_ms``: (device, autograd). device:
    the call captured once in a CUDA graph (its forward run on the
    capture stream first, so that autograd's backward runs there too)
    and the graph's replays timed, so no host work of autograd falls in
    the window; autograd: the call itself between the events, as
    earlier runs timed it."""
    import torch
    import torch.nn.functional as F

    def leaves():
        return tuple(t.detach().requires_grad_() for t in (q, k, v))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        xs = leaves()
        out = F.scaled_dot_product_attention(*xs, is_causal=causal,
                                             scale=1.0)
        for _ in range(2):      # warm-up on the capture stream
            torch.autograd.grad(out, xs, do, retain_graph=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        torch.autograd.grad(out, xs, do, retain_graph=True)
    device = time_ms(graph.replay, flush)
    del graph, out
    xs = leaves()
    out = F.scaled_dot_product_attention(*xs, is_causal=causal, scale=1.0)
    host = time_ms(lambda: torch.autograd.grad(out, xs, do,
                                               retain_graph=True), flush)
    return device, host


def profile_step(step, groups=PROFILE_GROUPS) -> dict:
    """Device time of one training step by kernel group (``groups``,
    first match by kernel name; the rest is "other": for
    PROFILE_GROUPS, elementwise, reductions, copies and the optimizer),
    from the kernel events of torch.profiler, with the ten largest
    kernels by name. Informational; the step runs after the launch
    counts were read."""
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
    by_group = {g: 0.0 for g, _ in groups}
    by_group["other"] = 0.0
    by_name = {}
    for ev in prof.events():
        # kernels, copies and sets; not the ranges that user annotations
        # (the optimizer's step) draw over them on the device
        if (ev.device_type != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        ms = ev.device_time_total / 1e3
        low = ev.name.lower()
        group = next((g for g, words in groups
                      if any(w in low for w in words)), "other")
        by_group[group] += ms
        tot, n = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (tot + ms, n + 1)
    busy = sum(by_group.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_ms_profiled": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall_ms,
            "by_group_ms": by_group,
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
            "whole_attention_backward": cfg.n_layer,
            "attention_delta": cfg.n_layer}
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
    want["attention_delta"] = cfg.n_layers
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


NARROW_RESNET = dict(stage_sizes=[1, 1, 1, 1], num_classes=10,
                     num_filters=8)


def resnet_narrow_step(dev) -> dict:
    """One trainer step of a narrow ResNet (bottleneck blocks, one per
    stage, 8 filters, 10 classes, f32) on a batch of 4 seeded 32 x 32
    images from the seeded init, on ``dev`` (the route the process
    group picks): the loss, the step's logits and the state_dict after
    it."""
    import torch
    from ray_tpu_torch.models import resnet
    from ray_tpu_torch.train import spmd
    model = resnet.ResNet(block_cls=resnet.BottleneckResNetBlock,
                          dtype=torch.float32, **NARROW_RESNET)
    rng = np.random.default_rng(SEED)
    batch = {"image": rng.standard_normal((4, 32, 32, 3), dtype=np.float32),
             "label": rng.integers(0, 10, (4,), dtype=np.int32)}
    tr = spmd.make_image_classifier_trainer(
        model, input_shape=(1, 32, 32, 3), device=dev)
    st = tr.init(SEED)
    logits = []
    st["model"].register_forward_hook(
        lambda mod, args, out: logits.append(out.detach()))
    st, m = tr.step(st, spmd.put_batch(tr, batch))
    return {"loss": float(m["loss"]), "logits": logits[0],
            **st["model"].state_dict()}


def resnet_gaps(got, want) -> dict:
    """phase 11a's measure of one narrow ResNet step against another:
    the loss's relative gap; each tensor's max gap over (1 + its max
    |want|); the worst tensor."""
    gaps = {k: float((got[k].cpu() - v.cpu()).abs().max()) / (
        1 + float(v.abs().max())) for k, v in want.items() if k != "loss"}
    worst = max(gaps, key=gaps.get)
    return {"loss_rel": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            "logits": gaps["logits"], "worst_tensor": worst,
            "worst": gaps[worst],
            "tol": {"loss_rel": RESNET_LOSS_REL, "tensors": RESNET_TOL}}


def hold_resnet(tag, gaps):
    require(gaps["loss_rel"] <= RESNET_LOSS_REL,
            f"{tag}: loss off by {gaps['loss_rel']} relative")
    require(gaps["worst"] <= RESNET_TOL,
            f"{tag}: {gaps['worst_tensor']} off by {gaps['worst']} of its "
            "scale")


def resnet_parity() -> dict:
    """The narrow ResNet step (``resnet_narrow_step``) on the card and
    on the CPU from the same seeded params (TF32 off, as phase 1 sets):
    the loss within RESNET_LOSS_REL relative; the step's logits, and the
    params and batch stats after it, within RESNET_TOL of each tensor's
    scale. Every conv and max-pool input on the card is channels_last
    (no hidden layout copy). Returns the measured gaps; fails outside
    the tolerances."""
    import torch
    import torch.nn.functional as F
    layouts = []
    conv2d, max_pool2d = F.conv2d, F.max_pool2d

    def spy(fn):
        def wrapped(x, *args, **kwargs):
            if x.is_cuda:
                layouts.append(x.is_contiguous(
                    memory_format=torch.channels_last))
            return fn(x, *args, **kwargs)
        return wrapped

    F.conv2d, F.max_pool2d = spy(conv2d), spy(max_pool2d)
    try:
        cpu, card = resnet_narrow_step("cpu"), resnet_narrow_step("cuda")
    finally:
        F.conv2d, F.max_pool2d = conv2d, max_pool2d
    res = {"loss_cpu": cpu["loss"], "loss_cuda": card["loss"],
           **resnet_gaps(card, cpu),
           "conv_pool_inputs": len(layouts),
           "channels_last": sum(layouts)}
    print("resnet_parity", json.dumps(res), flush=True)
    require(layouts and all(layouts),
            f"resnet: {len(layouts) - sum(layouts)} of {len(layouts)} conv "
            "or pool inputs on the card are not channels_last")
    hold_resnet("resnet", res)
    return res


def hold_mesh_step(tag, mesh, plain):
    """phase 12c for GPT-2: ``one_step`` on the mesh route against the
    same step without a group (f32, kernels on both): loss and
    grad_norm within MESH_REL relative, params within 1e-6 where the
    step's |grad| passes PARAM_MASK (hold_step's rule: AdamW's first
    step turns the last bits of a grad near eps into up to lr); the
    share left out is printed."""
    rel = {k: abs(mesh[k] - plain[k]) / abs(plain[k])
           for k in ("loss", "grad_norm")}
    held = {n: g.abs() > PARAM_MASK for n, g in plain["grads"].items()}
    diff = {n: (mesh["params"][n] - p).abs()
            for n, p in plain["params"].items()}
    p_err = max(float(d[held[n]].max()) if held[n].any() else 0.0
                for n, d in diff.items())
    n_held = sum(int(m.sum()) for m in held.values())
    n_all = sum(m.numel() for m in held.values())
    res = {**rel, "params_max_abs_err": p_err,
           "params_left_out_share": 1 - n_held / n_all,
           "launches": {"mesh": mesh["launches"], "plain": plain["launches"]},
           "tol": {"loss": MESH_REL, "grad_norm": MESH_REL,
                   "params_max_abs_err": 1e-6}}
    print(tag, json.dumps(res), flush=True)
    require(rel["loss"] <= MESH_REL and rel["grad_norm"] <= MESH_REL,
            f"{tag}: loss / grad_norm off by {rel}")
    require(p_err <= 1e-6, f"{tag}: params off by {p_err}")
    require(mesh["launches"] == plain["launches"],
            f"{tag}: the routes launched {res['launches']}")
    return res


def mesh_phase(cfg, tokens, phase6, phase11, name, card):
    """Phase 12 (module docstring): (c) the narrow steps without a
    group, the group, (c) again on the mesh route, (a) GPT-2 small and
    the exact=True line, (b) ResNet-50; the group is destroyed however
    the phase ends. Returns the kernels' launch counts of (a)'s timed
    steps ("gpt2_train") and of the exact step ("gpt2_exact")."""
    import torch
    import torch.distributed as dist
    from ray_tpu_torch import bench, kernels
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.parallel import collectives
    from ray_tpu_torch.train import spmd

    narrow = dataclasses.replace(cfg, n_layer=2, dtype=torch.float32)
    plain = {"gpt2": one_step(narrow, A.TRAINING_KERNELS, tokens),
             "resnet": resnet_narrow_step("cuda")}
    with one_rank_group():
        # (c) the mesh route against the route without a group
        collectives.reset_call_counts()
        mesh_gpt2 = one_step(narrow, A.TRAINING_KERNELS, tokens)
        require(collectives.call_counts().get("all_reduce", 0) > 0,
                "the mesh route's GPT-2 step ran no collective")
        hold_mesh_step("mesh_gpt2_numerics", mesh_gpt2, plain["gpt2"])
        del mesh_gpt2, plain["gpt2"]
        collectives.reset_call_counts()
        mesh_resnet = resnet_narrow_step("cuda")
        n_bn = 1 + 4 * 3 + 4        # the narrow net's batch norms
        bn_calls = collectives.call_counts().get("all_gather", 0)
        gaps = resnet_gaps(mesh_resnet, plain["resnet"])
        print("mesh_resnet_numerics", json.dumps(
            {**gaps, "bn_all_gathers": bn_calls}), flush=True)
        require(bn_calls == n_bn, f"mesh resnet step: {bn_calls} batch-norm "
                 f"all_gathers, want {n_bn}")
        hold_resnet("mesh_resnet_numerics", gaps)
        del mesh_resnet, plain

        # (a) GPT-2 small through the bench on the mesh route
        g = bench.gpt2_loop(profile=profile_step)
        counts, n_steps = g["gpt2_launches"], g["gpt2_steps_timed"]
        require(all(math.isfinite(x) for x in g["gpt2_losses"]),
                f"mesh gpt2: non-finite loss {g['gpt2_losses']}")
        want = {k: cfg.n_layer * n_steps for k in
                ("whole_attention_forward", "whole_attention_backward",
                 "attention_delta")}
        require(counts == want, f"mesh gpt2: launched {counts}, want {want}")
        out = {"gpt2_train": counts}
        calls = g["gpt2_collective_calls"]
        require(calls.get("all_reduce", 0) > 0,
                f"mesh gpt2: collectives {calls}")
        print("mesh_train", json.dumps({
            "model": "gpt2-small", "world_size": dist.get_world_size(),
            "backend": dist.get_backend(),
            "step_time_ms": g["gpt2_step_time_ms"],
            "tokens_per_sec": g["gpt2_tokens_per_sec_per_chip"],
            "phase6_step_time_ms": phase6["gpt2_step_time_ms"],
            "phase6_tokens_per_sec": phase6["gpt2_tokens_per_sec_per_chip"],
            "ms_by_window": g["gpt2_ms_by_window"],
            "launches": counts, "steps_timed": n_steps,
            "collective_calls": calls,
            "max_memory_allocated_bytes":
                g["gpt2_max_memory_allocated_bytes"],
            "losses": g["gpt2_losses"], "device": name,
            "nvidia_smi": card}), flush=True)
        print("mesh_train_profile", json.dumps(g["gpt2_profile"]),
              flush=True)
        del g
        torch.cuda.empty_cache()

        # the streaming route of GPT-2 training: exact=True at 2 x 4096
        xcfg = dataclasses.replace(cfg, n_layer=2, n_positions=4096)
        tr = spmd.make_causal_lm_trainer(xcfg, exact=True)
        st = tr.init(SEED)
        ids = np.random.default_rng(SEED).integers(
            0, xcfg.vocab_size, (2, 4096), dtype=np.int32)
        batch = spmd.put_batch(tr, {"input_ids": ids, "labels": ids})
        kernels.reset_launch_counts()
        st, m = tr.step(st, batch)
        loss = float(m["loss"])
        counts = kernels.launch_counts()
        want = {k: xcfg.n_layer for k in
                ("flash_attention_forward", "flash_attention_backward_dkv",
                 "flash_attention_backward_dq", "attention_delta")}
        print("mesh_exact", json.dumps({"n_layer": xcfg.n_layer, "batch": 2,
                                        "seq": 4096, "loss": loss,
                                        "launches": counts}), flush=True)
        require(math.isfinite(loss), f"exact step: loss {loss}")
        require(counts == want, f"exact step launched {counts}, want {want}")
        out["gpt2_exact"] = counts
        del tr, st, batch
        torch.cuda.empty_cache()

        # (b) ResNet-50 through the bench on the mesh route
        r = bench.resnet_loop(profile=lambda step: profile_step(
            step, RESNET_PROFILE_GROUPS))
        require(all(math.isfinite(x) for x in r["losses"]),
                f"mesh resnet: non-finite loss {r['losses']}")
        require(r["launches"] == {}, f"mesh resnet launched {r['launches']}")
        n_bn = 1 + 16 * 3 + 4       # ResNet-50's batch norms
        gathers = r["collective_calls"].get("all_gather", 0)
        require(gathers == n_bn * r["steps_timed"],
                f"mesh resnet: {gathers} all_gathers in {r['steps_timed']} "
                f"steps of {n_bn} batch norms")
        print("mesh_resnet_train", json.dumps({
            "model": "resnet50", "world_size": dist.get_world_size(),
            "backend": dist.get_backend(),
            "step_time_ms": r["step_time_ms"],
            "img_per_sec": r["img_per_sec"],
            "phase11_step_time_ms": phase11["step_time_ms"],
            "phase11_img_per_sec": phase11["img_per_sec"],
            "ms_by_window": r["ms_by_window"],
            "collective_calls": r["collective_calls"],
            "steps_timed": r["steps_timed"],
            "max_memory_allocated_bytes": r["max_memory_allocated_bytes"],
            "device": name, "nvidia_smi": card}), flush=True)
        print("mesh_resnet_profile", json.dumps(r["profile"]), flush=True)
    return out


@contextlib.contextmanager
def one_rank_group():
    """A NCCL process group of one rank in this process (a file store in
    a new temporary directory), destroyed however the block ends."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from ray_tpu_torch.parallel import collectives
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    collectives.initialize_distributed(
        "file://" + os.path.join(store, "store"), 1, 0,
        local_device_ids=[0], backend="nccl")
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def ring_inputs(B, H, S, D, seed=SEED):
    """q (pre-scaled by D^-0.5, as the ring hands it to each block), k,
    v and do [B, H, S, D] bf16 on the card, from a seeded generator."""
    import torch
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(B, H, S, D, generator=g).to(
        "cuda", torch.bfloat16) for _ in range(4))
    return (q * D ** -0.5).to(torch.bfloat16), k, v, do


def whole_sequence(q, k, v, do, impl):
    """``impl``'s streaming triple once on the whole sequence, causal:
    (o, lse, dq, dk, dv)."""
    o, lse = impl.forward(q, k, v, causal=True)
    delta = impl.delta(o, do)
    dk, dv = impl.backward_dkv(q, k, v, do, lse, delta, causal=True)
    dq = impl.backward_dq(q, k, v, do, lse, delta, causal=True)
    return o, lse, dq, dk, dv


def f64_yardstick(q, k, v, do):
    """The whole sequence's (o, lse, dq, dk, dv) in f64, causal, a few
    heads at a time (the backward from the exact o and lse)."""
    from ray_tpu_torch.ops import attention as A
    o, lse = A.flash_attention_forward_f64(q, k, v, causal=True)
    return (o, lse) + A.flash_attention_backward_f64(q, k, v, o, lse, do,
                                                     causal=True)


def ring_phase(n, sl, name, card) -> dict:
    """Phase 14a: the ring's schedule for every rank of an ``n``-rank
    ring of ``sl`` tokens a rank at Llama-2-7B's attention widths, in
    this process. Returns the launch counts and the times."""
    import torch
    from ray_tpu_torch import kernels
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.ops import ring_attention as R
    names = ("o", "lse", "dq", "dk", "dv")
    B, H, D = 1, 32, 128
    q, k, v, do = ring_inputs(B, H, n * sl, D)
    K = A.TRAINING_KERNELS
    kernels.reset_launch_counts()
    ring = R.simulated_ring(q, k, v, do, n, impl=K)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    blocks = n * (n + 1) // 2
    want = {"flash_attention_forward": blocks,
            "flash_attention_backward_dkv": blocks,
            "flash_attention_backward_dq": blocks, "attention_delta": n}
    require(counts == want, f"ring schedule launched {counts}, want {want}")
    whole = whole_sequence(q, k, v, do, K)
    torch.cuda.synchronize()
    require(all(bool(torch.isfinite(t).all()) for t in ring),
            "ring: non-finite output")
    held, bad = held_outputs(list(zip(ring, whole)),
                             lambda: f64_yardstick(q, k, v, do), names,
                             RING_RATIO)
    max_abs = {n_: float((a.float() - b.float()).abs().max())
               for n_, a, b in zip(names, ring, whole)}

    # each rank's device time: CUDA events between the schedule's steps
    # (one stream, so the events split the device's time among the ranks)
    def timed_ring():
        marks = []

        def on_step(rank):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((rank, ev))
        R.simulated_ring(q, k, v, do, n, impl=K, on_step=on_step)
        torch.cuda.synchronize()
        ms = [0.0] * n
        for (rank, a), (_, b) in zip(marks, marks[1:]):
            if rank is not None:
                ms[rank] += a.elapsed_time(b)
        return ms
    rank_ms = [min(x) for x in zip(*[timed_ring() for _ in range(3)])]
    whole_ms = []
    for _ in range(3):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        whole_sequence(q, k, v, do, K)
        e1.record()
        torch.cuda.synchronize()
        whole_ms.append(e0.elapsed_time(e1))
    res = {"shape": [B, H, n * sl, D], "sp": n, "tokens_per_rank": sl,
           "dtype": "bfloat16", "causal": True, "launches": counts,
           "held_against_whole": held, "max_abs_err": max_abs,
           "tol": {"float32": F32_TOL, "bfloat16": RING_RATIO},
           "rank_ms": rank_ms, "whole_ms": min(whole_ms),
           "whole_quarter_ms": min(whole_ms) / n,
           "last_rank_over_quarter": rank_ms[-1] / (min(whole_ms) / n),
           "device": name, "nvidia_smi": card}
    print("ring_schedule", json.dumps(res), flush=True)
    require(not bad, f"ring vs whole sequence: {bad} outside their "
            f"tolerance: {held}")
    del q, k, v, do, ring, whole
    torch.cuda.empty_cache()

    # kernel blocks against plain blocks, both rings, at a shape where
    # the f64 function and the plain versions are cheap
    q, k, v, do = ring_inputs(1, 4, n * 512, D, SEED + 1)
    kern = R.simulated_ring(q, k, v, do, n, impl=K)
    plain = R.simulated_ring(q, k, v, do, n, impl=A.TRAINING_PLAIN)
    hold_outputs(f"ring {n} x 512, kernels vs plain blocks", "bfloat16",
                 dict(zip(names, zip(kern, plain))),
                 lambda: f64_yardstick(q, k, v, do))
    return res


def ring_trainer_phase(phase6, name, card) -> dict:
    """Phase 14b: GPT-2 small with attention_backend="ring" through
    make_causal_lm_trainer on the one-rank NCCL group (sp = 1). Returns
    the launch counts of the bench's timed steps."""
    import torch
    from ray_tpu_torch import bench, kernels
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import spmd
    cfg = gpt2.GPT2Config.small()
    ring_cfg = dataclasses.replace(cfg, attention_backend="ring")
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (16, 1024), dtype=np.int32)
    steps = {}
    for label, c, exact in (("ring", ring_cfg, False),
                            ("exact", cfg, True)):
        tr = spmd.make_causal_lm_trainer(c, exact=exact)
        st = tr.init(SEED)
        batch = spmd.put_batch(tr, {"input_ids": tokens, "labels": tokens})
        kernels.reset_launch_counts()
        st, m = tr.step(st, batch)
        steps[label] = {"loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"]),
                        "launches": kernels.launch_counts()}
        del tr, st, batch
        torch.cuda.empty_cache()
    rel = {k: abs(steps["ring"][k] - steps["exact"][k])
           / abs(steps["exact"][k]) for k in ("loss", "grad_norm")}
    print("ring_trainer_step", json.dumps({**steps, "rel": rel,
                                           "tol": MESH_REL}), flush=True)
    require(max(rel.values()) <= MESH_REL,
            f"ring trainer vs exact=True: {rel}")
    g = bench.gpt2_loop(config=ring_cfg)
    counts, n_steps = g["gpt2_launches"], g["gpt2_steps_timed"]
    want = {k: cfg.n_layer * n_steps for k in
            ("flash_attention_forward", "flash_attention_backward_dkv",
             "flash_attention_backward_dq", "attention_delta")}
    require(counts == want, f"ring trainer launched {counts}, want {want}")
    require(all(math.isfinite(x) for x in g["gpt2_losses"])
            and g["gpt2_losses"][-1] < g["gpt2_losses"][0],
            f"ring trainer: losses {g['gpt2_losses']}")
    print("ring_train", json.dumps({
        "model": "gpt2-small, attention_backend=ring, sp 1",
        "step_time_ms": g["gpt2_step_time_ms"],
        "tokens_per_sec": g["gpt2_tokens_per_sec_per_chip"],
        "phase6_step_time_ms": phase6["gpt2_step_time_ms"],
        "phase6_tokens_per_sec": phase6["gpt2_tokens_per_sec_per_chip"],
        "launches": counts, "steps_timed": n_steps,
        "max_memory_allocated_bytes": g["gpt2_max_memory_allocated_bytes"],
        "losses": g["gpt2_losses"], "device": name, "nvidia_smi": card}),
        flush=True)
    return counts


def pipelined_phase(phase6, name, card) -> dict:
    """Phase 14c: make_pipelined_lm_trainer on GPT-2 small at pp = 1 on
    the one-rank NCCL group, M = 4 microbatches of 4 x 1024 bf16.
    Returns the launch counts of the timed steps."""
    import torch
    from ray_tpu_torch import kernels
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import spmd
    cfg = gpt2.GPT2Config.small()
    M, mb, T = 4, 4, 1024
    warmup, windows, per_window = 1, 3, 2
    tr = spmd.make_pipelined_lm_trainer(cfg)
    st = tr.init(SEED)
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (M, mb, T), dtype=np.int32)
    batch = spmd.put_batch(tr, {"input_ids": tokens, "labels": tokens})
    torch.cuda.reset_peak_memory_stats()
    ref = float(tr.eval_loss(st, batch))
    st, m = tr.step(st, batch)
    first = float(m["loss"])
    rel = abs(first - ref) / abs(ref)
    losses = [first]
    for _ in range(warmup):
        losses.append(float(tr.step(st, batch)[1]["loss"]))
    kernels.reset_launch_counts()
    host_ms = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms = [tr.step(st, batch)[1]["loss"] for _ in range(per_window)]
        losses += [float(x) for x in ms]        # host read: synchronised
        host_ms.append((time.perf_counter() - t0) * 1e3 / per_window)
    counts = kernels.launch_counts()
    n_steps = windows * per_window
    L = cfg.n_layer
    want = {"whole_attention_forward": 2 * L * M * n_steps,
            "whole_attention_backward": L * M * n_steps,
            "attention_delta": L * M * n_steps}
    best = min(host_ms)
    res = {"model": "gpt2-small, pipelined, pp 1", "microbatches": M,
           "microbatch": [mb, T], "eval_loss": ref, "first_step_loss": first,
           "loss_rel_to_eval_loss": rel, "tol": MESH_REL,
           "step_time_ms": best, "tokens_per_sec": M * mb * T / best * 1e3,
           "ms_by_window": host_ms,
           "phase6_step_time_ms": phase6["gpt2_step_time_ms"],
           "phase6_tokens_per_sec": phase6["gpt2_tokens_per_sec_per_chip"],
           "launches": counts, "launches_want": want,
           "steps_timed": n_steps,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "phase6_max_memory_allocated_bytes":
               phase6["gpt2_max_memory_allocated_bytes"],
           "losses": losses, "device": name, "nvidia_smi": card}
    print("pipelined_train", json.dumps(res), flush=True)
    require(all(math.isfinite(x) for x in losses), f"pipelined: {losses}")
    require(rel <= MESH_REL, f"pipelined step loss {first} vs eval_loss {ref}")
    require(losses[-1] < losses[0], f"pipelined: loss did not fall {losses}")
    require(counts == want, f"pipelined launched {counts}, want {want}")
    print("pipelined_profile", json.dumps(profile_step(
        lambda: tr.step(st, batch))), flush=True)
    del tr, st, batch
    torch.cuda.empty_cache()
    return counts


def moe_phase() -> dict:
    """Phase 14d: the dry run's phase 4 MoE step (one device) in f32 on
    the card against the same step on the CPU."""
    from ray_tpu_torch.parallel import dryrun
    x = np.random.default_rng(5).standard_normal((16, 16)).astype(
        np.float32)
    cpu, card = dryrun.moe_sgd(None, x), dryrun.moe_sgd(None, x,
                                                         device="cuda")
    pairs = {"losses": (card["losses"], cpu["losses"]),
             "y": (card["y"], cpu["y"]), "aux": (card["aux"], cpu["aux"]),
             **{f"grad {k}": (card["grads"][k], v)
                for k, v in cpu["grads"].items()}}
    err = {k: float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
           for k, (a, b) in pairs.items()}
    ok = {k: bool(np.allclose(a, b, rtol=MOE_RTOL, atol=MOE_ATOL))
          for k, (a, b) in pairs.items()}
    res = {"losses_cuda": card["losses"], "losses_cpu": cpu["losses"],
           "max_abs_err": err, "tol": {"rtol": MOE_RTOL, "atol": MOE_ATOL}}
    print("moe_step", json.dumps(res), flush=True)
    require(all(ok.values()), f"moe card vs cpu: {ok}")
    require(card["losses"][1] < card["losses"][0],
            f"moe: loss did not fall {card['losses']}")
    return res


def ppo_learn_parity(device) -> dict:
    """Phase 15b (1): one PPOPolicy.learn_on_batch on ``device`` against
    the same call on the CPU: a CartPole-sized MLP (f32) built from one
    seed on both (the init draws on the CPU), a fixed batch whose ratios
    and value errors pass their clips; stats and params within PPO_F32
    of their scale."""
    from ray_tpu_torch.rllib import Box, Discrete
    from ray_tpu_torch.rllib.algorithms.ppo import PPOPolicy
    from ray_tpu_torch.rllib.sample_batch import SampleBatch
    rng = np.random.default_rng(SEED)
    n = 256
    batch = SampleBatch({
        "obs": rng.standard_normal((n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int32),
        "action_logp": rng.uniform(-1.5, -0.2, n).astype(np.float32),
        "advantages": rng.standard_normal(n).astype(np.float32),
        "value_targets": (5 * rng.standard_normal(n)).astype(np.float32)})
    cfg = {"seed": SEED, "lr": 3e-4, "clip_param": 0.1, "grad_clip": 0.5,
           "entropy_coeff": 0.01}
    runs = {}
    for dev in ("cpu", device):
        pol = PPOPolicy(Box(-1, 1, (4,)), Discrete(2), dict(cfg, device=dev))
        stats = pol.learn_on_batch(batch)
        runs[dev] = (stats, pol.get_weights())
    (cs, cw), (ds, dw) = runs["cpu"], runs[device]
    gaps = {k: abs(ds[k] - v) / (1 + abs(v)) for k, v in cs.items()}
    gaps.update({k: float(np.max(np.abs(dw[k] - v))) / (
        1 + float(np.max(np.abs(v)))) for k, v in cw.items()})
    worst = max(gaps, key=gaps.get)
    res = {"stats_cuda": ds, "stats_cpu": cs, "worst": worst,
           "worst_gap_of_scale": gaps[worst], "tol": PPO_F32}
    print("ppo_learn_parity", json.dumps(res), flush=True)
    require(gaps[worst] <= PPO_F32, f"ppo learn_on_batch card vs cpu: "
            f"{worst} off by {gaps[worst]} of its scale")
    return res


def atari_cnn_parity(device) -> dict:
    """Phase 15b (2): AtariCNN as make_model builds it (bf16 trunk, f32
    heads) at 84 x 84 x 4 on ``device`` against an f64 forward of the
    same params on the CPU, beside the CPU bf16 forward's error: (max,
    rms) ratios at most ATARI_BF16_RATIO."""
    import torch
    from ray_tpu_torch.rllib.models import AtariCNN
    shape = (84, 84, 4)
    gen = torch.Generator().manual_seed(SEED)
    cpu = AtariCNN(shape, 6).init_weights(gen)
    card = AtariCNN(shape, 6).to(device)
    card.load_state_dict(cpu.state_dict())
    f64 = AtariCNN(shape, 6, compute_dtype=torch.float64).double()
    f64.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (256, *shape)).astype(np.uint8))
    with torch.no_grad():
        ref = [t.numpy() for t in f64(x)]
        outs = {"cpu": [t.double().numpy() for t in cpu(x)],
                "cuda": [t.double().cpu().numpy() for t in card(x.to(device))]}
    res = {}
    for i, what in enumerate(("logits", "value")):
        err = {k: (float(np.max(np.abs(o[i] - ref[i]))),
                   float(np.sqrt(np.mean((o[i] - ref[i]) ** 2))))
               for k, o in outs.items()}
        ratio = [c / max(p, 1e-30) for c, p in zip(err["cuda"], err["cpu"])]
        res[what] = {"err_cuda": err["cuda"], "err_cpu": err["cpu"],
                     "ratio": ratio}
        require(all(np.isfinite(outs["cuda"][i]).ravel()),
                f"atari cnn {what}: not finite")
        require(ratio[0] <= ATARI_BF16_RATIO[0]
                and ratio[1] <= ATARI_BF16_RATIO[1],
                f"atari cnn {what}: ratios {ratio} over {ATARI_BF16_RATIO}")
    print("atari_cnn_parity", json.dumps({**res, "shape": [256, *shape],
                                          "limit": ATARI_BF16_RATIO}),
          flush=True)
    return res


def ppo_phase(name, card) -> dict:
    """Phase 15: (b) the card against the CPU, (a) PPO-Atari through
    bench.ppo_loop with one learn phase profiled, (c) no launch of the
    port's kernels across the phase."""
    import torch
    from ray_tpu_torch import bench, kernels
    kernels.reset_launch_counts()
    ppo_learn_parity("cuda")
    atari_cnn_parity("cuda")
    r = bench.ppo_loop(profile=lambda learn: profile_step(
        learn, PPO_PROFILE_GROUPS))
    launches = kernels.launch_counts()
    profile = r.pop("ppo_profile")
    print("ppo_train", json.dumps({**r, "device": name, "nvidia_smi": card}),
          flush=True)
    print("ppo_profile", json.dumps(profile), flush=True)
    require(r["ppo_obs_shape"] == [84, 84, 4]
            and r["ppo_env_steps_per_iter"] == 5000
            and r["ppo_num_envs"] == 50 and r["ppo_minibatch"] == 500
            and r["ppo_num_sgd_iter"] == 10, f"ppo widths: {r}")
    require(all(math.isfinite(x) for x in r["ppo_total_losses"]),
            f"ppo: non-finite loss {r['ppo_total_losses']}")
    require(r["ppo_weights_moved"] > 0, "ppo: the weights did not move")
    require(launches == {}, f"ppo: the RL path launched {launches}")
    torch.cuda.empty_cache()
    return r


def learn_gaps(want, got) -> dict:
    """{name: gap of scale} of one run against another, each a list of
    (stats, weights) after successive updates: per stat (arrays such as
    DQN's td_errors by their max) and per param, |got - want| over
    1 + max |want|, worst over the updates."""
    gaps = {}
    for (ws, ww), (gs, gw) in zip(want, got):
        for k, v in {**ws, **ww}.items():
            g = np.asarray({**gs, **gw}[k], np.float64)
            v = np.asarray(v, np.float64)
            gap = float(np.max(np.abs(g - v))) / (1 + float(np.max(
                np.abs(v))))
            gaps[k] = max(gaps.get(k, 0.0), gap)
    return gaps


def hold_learn(tag, cpu, card) -> dict:
    """Prints and requires ``learn_gaps(cpu, card)`` within PPO_F32."""
    gaps = learn_gaps(cpu, card)
    worst = max(gaps, key=gaps.get)
    res = {"worst": worst, "worst_gap_of_scale": gaps[worst],
           "tol": PPO_F32, "updates": len(cpu),
           "stats_cuda": {k: v for k, v in card[-1][0].items()
                          if np.ndim(v) == 0}}
    print(tag, json.dumps(res), flush=True)
    require(gaps[worst] <= PPO_F32, f"{tag} card vs cpu: {worst} off by "
            f"{gaps[worst]} of its scale")
    return res


def vtrace_mlp_batch(n=256):
    """A fixed MLP batch for IMPALA/APPO: the behaviour log-probs put the
    ratios on both sides of the clips; terminals and cuts inside."""
    from ray_tpu_torch.rllib.sample_batch import SampleBatch
    rng = np.random.default_rng(SEED)
    terms = rng.random(n) < 0.05
    cuts = np.maximum(terms, rng.random(n) < 0.1).astype(np.float32)
    cuts[-1] = 1.0
    return SampleBatch({
        "obs": rng.standard_normal((n, 4)).astype(np.float32),
        "new_obs": rng.standard_normal((n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int32),
        "action_logp": rng.uniform(-2.5, -0.2, n).astype(np.float32),
        "rewards": rng.standard_normal(n).astype(np.float32),
        "dones": terms, "cuts": cuts,
        "eps_id": np.cumsum(cuts).astype(np.int64)})


def dqn_mlp_batch(n=256, seed=SEED):
    from ray_tpu_torch.rllib.sample_batch import SampleBatch
    rng = np.random.default_rng(seed)
    return SampleBatch({
        "obs": rng.standard_normal((n, 4)).astype(np.float32),
        "new_obs": rng.standard_normal((n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int64),
        "rewards": rng.standard_normal(n).astype(np.float32),
        "dones": rng.random(n) < 0.1,
        "weights": rng.uniform(0.2, 1.0, n).astype(np.float32),
        "batch_indexes": np.arange(n, dtype=np.int64)})


def rl_learn_parity(device) -> dict:
    """Phase 16b (1): one IMPALAPolicy and one APPOPolicy
    ``learn_on_batch`` on a fixed MLP batch with cuts and terminals, and
    two DQNPolicy ``learn_on_batch`` with double-Q and weights (the
    second after the online net moved off the target), each on
    ``device`` against the same calls on the CPU: CartPole-sized f32
    MLPs built from one seed on both (the init draws on the CPU); stats
    (DQN's per-sample td_errors included) and params within PPO_F32 of
    their scale."""
    from ray_tpu_torch.rllib import Box, Discrete
    from ray_tpu_torch.rllib.algorithms import (APPOPolicy, DQNPolicy,
                                                IMPALAPolicy)
    cfg = {"seed": SEED, "lr": 5e-4, "grad_clip": 40.0}
    out = {}
    cases = (("impala_learn_parity", IMPALAPolicy, [vtrace_mlp_batch()]),
             ("appo_learn_parity", APPOPolicy, [vtrace_mlp_batch()]),
             ("dqn_learn_parity", DQNPolicy,
              [dqn_mlp_batch(), dqn_mlp_batch(seed=SEED + 1)]))
    for tag, cls, batches in cases:
        runs = {}
        for dev in ("cpu", device):
            pol = cls(Box(-1, 1, (4,)), Discrete(2), dict(cfg, device=dev))
            runs[dev] = [(pol.learn_on_batch(b), pol.get_weights())
                         for b in batches]
        out[tag] = hold_learn(tag, runs["cpu"], runs[device])
    return out


def vtrace_loop(behaviour_logp, target_logp, rewards, values, next_values,
                terms, cuts, gamma):
    """V-trace's recurrence as a row loop on [T] tensors (three launches
    a row): what the scan replaces, timed beside it."""
    import torch
    rho = torch.clamp(torch.exp(target_logp - behaviour_logp), max=1.0)
    deltas = rho * (rewards + gamma * (1 - terms) * next_values - values)
    a = gamma * (1 - cuts) * rho
    acc = torch.empty_like(values)
    nxt = torch.zeros((), device=values.device)
    for t in range(values.shape[0] - 1, -1, -1):
        nxt = deltas[t] + a[t] * nxt
        acc[t] = nxt
    return values + acc


def vtrace_parity(device, flush) -> dict:
    """Phase 16b (2): ``vtrace`` on a 500-row sequence (IMPALA-Atari's
    train batch; cuts and terminals inside, the rho clip taken) on
    ``device`` in f32 against the f64 row loop on the CPU, within
    PPO_F32 of scale; its device time (CUDA events, L2 flushed) beside
    the row loop's on the card."""
    import torch
    from ray_tpu_torch.rllib.algorithms.impala import vtrace, vtrace_f64
    n, gamma = 500, 0.99
    rng = np.random.default_rng(SEED)
    terms = (rng.random(n) < 0.02).astype(np.float32)
    cuts = np.maximum(terms, rng.random(n) < 0.02).astype(np.float32)
    cuts[49::50] = 1.0
    args = [rng.uniform(-2.0, -0.1, n), rng.uniform(-2.0, -0.1, n),
            rng.standard_normal(n), 3 * rng.standard_normal(n),
            3 * rng.standard_normal(n), terms, cuts]
    args = [np.asarray(a, np.float32) for a in args]
    want = vtrace_f64(*args, gamma)
    targs = [torch.from_numpy(a).to(device) for a in args]
    got = [t.cpu().numpy() for t in vtrace(*targs, gamma)]
    gaps = {k: float(np.max(np.abs(g - w))) / (1 + float(np.max(np.abs(w))))
            for k, g, w in zip(("vs", "pg_adv"), got, want)}
    loop_vs = vtrace_loop(*targs, gamma).cpu().numpy()
    gaps["vs_row_loop"] = float(np.max(np.abs(loop_vs - want[0]))) / (
        1 + float(np.max(np.abs(want[0]))))
    res = {"rows": n, "gaps_of_scale": gaps, "tol": PPO_F32,
           "scan_ms": time_ms(lambda: vtrace(*targs, gamma), flush),
           "row_loop_ms": time_ms(lambda: vtrace_loop(*targs, gamma), flush,
                                  iters=3)}
    print("vtrace_parity", json.dumps(res), flush=True)
    require(max(gaps.values()) <= PPO_F32, f"vtrace card vs f64: {gaps}")
    return res


def learner_thread_parity(device) -> dict:
    """Phase 16b (3): K = 4 fixed batches through a LearnerThread on
    ``device`` while the main thread reads weights under its lock, against
    the same batches through ``learn_on_batch`` inline on a second
    policy from the same seed on ``device``: the weights within PPO_F32
    of their scale, every batch learned, ``check_error()`` clean."""
    from ray_tpu_torch.rllib import Box, Discrete
    from ray_tpu_torch.rllib.algorithms import IMPALAPolicy
    from ray_tpu_torch.rllib.execution import LearnerThread
    k = 4
    batches = []
    for i in range(k):
        b = vtrace_mlp_batch()
        b["rewards"] = b["rewards"] + np.float32(i)
        batches.append(b)
    cfg = {"seed": SEED, "lr": 5e-4, "grad_clip": 40.0, "device": device}
    threaded = IMPALAPolicy(Box(-1, 1, (4,)), Discrete(2), dict(cfg))
    inline = IMPALAPolicy(Box(-1, 1, (4,)), Discrete(2), dict(cfg))
    thread = LearnerThread(threaded)
    thread.start()
    for b in batches:
        require(thread.put(b, timeout=60.0), "learner thread: queue full")
    reads = 0
    deadline = time.monotonic() + 120.0
    while thread.num_steps < k:
        thread.check_error()
        require(thread.is_alive() and time.monotonic() < deadline,
                f"learner thread stalled at {thread.num_steps} of {k}")
        thread.get_weights()
        reads += 1
        time.sleep(0.002)
    thread.stop()
    thread.join(timeout=60.0)
    require(not thread.is_alive(), "learner thread did not stop")
    thread.check_error()
    for b in batches:
        inline.learn_on_batch(b)
    gaps = learn_gaps([({}, inline.get_weights())],
                      [({}, thread.get_weights())])
    worst = max(gaps, key=gaps.get)
    res = {"batches": k, "steps": thread.num_steps, "weight_reads": reads,
           "worst": worst, "worst_gap_of_scale": gaps[worst], "tol": PPO_F32,
           "metrics": thread.metrics()}
    print("learner_thread_parity", json.dumps(res), flush=True)
    require(gaps[worst] <= PPO_F32, f"learner thread vs inline: {worst} "
            f"off by {gaps[worst]} of its scale")
    return res


def rl_algos_phase(name, card) -> dict:
    """Phase 16: (b) the card against the CPU (IMPALA, APPO and DQN
    updates, V-trace, the learner thread), (a) IMPALA-Atari (and one
    APPO pass) through bench.impala_loop and DQN-Atari through
    bench.dqn_loop, each with one learn phase profiled, (c) no launch
    of the port's kernels across the phase."""
    import torch
    from ray_tpu_torch import bench, kernels
    kernels.reset_launch_counts()
    l2_flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    rl_learn_parity("cuda")
    vtrace_parity("cuda", l2_flush.zero_)
    del l2_flush
    learner_thread_parity("cuda")

    def show(tag, r, key):
        profile = r.pop(key, None)
        print(tag, json.dumps({**r, "device": name, "nvidia_smi": card}),
              flush=True)
        if profile is not None:
            print(tag.replace("_train", "_profile"), json.dumps(profile),
                  flush=True)

    r = bench.impala_loop(profile=lambda learn: profile_step(
        learn, PPO_PROFILE_GROUPS))
    show("impala_train", r, "impala_profile")
    require(r["impala_obs_shape"] == [84, 84, 4]
            and r["impala_env_steps_per_iter"] == 500
            and r["impala_num_envs"] == 10, f"impala widths: {r}")
    require(all(math.isfinite(x) for x in r["impala_total_losses"]),
            f"impala: non-finite loss {r['impala_total_losses']}")
    require(r["impala_weights_moved"] > 0, "impala: the weights did not move")
    a = bench.impala_loop(algo="APPO", timed=1)
    show("appo_train", a, "impala_profile")
    require(a["impala_obs_shape"] == [84, 84, 4]
            and all(math.isfinite(x) for x in a["impala_total_losses"])
            and a["impala_weights_moved"] > 0, f"appo: {a}")
    d = bench.dqn_loop(profile=lambda learn: profile_step(
        learn, PPO_PROFILE_GROUPS))
    show("dqn_train", d, "dqn_profile")
    require(d["dqn_obs_shape"] == [84, 84, 4] and d["dqn_num_envs"] == 8
            and d["dqn_train_batch_size"] == 32
            and d["dqn_replay_capacity"] == 50_000, f"dqn widths: {d}")
    require(all(math.isfinite(x) for x in d["dqn_total_losses"]),
            f"dqn: non-finite loss {d['dqn_total_losses']}")
    require(d["dqn_weights_moved"] > 0, "dqn: the weights did not move")
    require(d["dqn_replay_size"][1] > d["dqn_replay_size"][0],
            f"dqn: the replay buffer did not grow {d['dqn_replay_size']}")
    require(d["dqn_epsilon"][1] < d["dqn_epsilon"][0],
            f"dqn: epsilon did not fall {d['dqn_epsilon']}")
    require(d["dqn_target_updates"][1] > d["dqn_target_updates"][0],
            f"dqn: the target never synced {d['dqn_target_updates']}")
    launches = kernels.launch_counts()
    require(launches == {}, f"rl algorithms: the path launched {launches}")
    torch.cuda.empty_cache()
    return {"impala": r, "appo": a, "dqn": d}


def offpolicy_batch(n=256, seed=SEED, bc_weight=None):
    """A fixed Pendulum-shaped batch (obs 3, action 1) for the SAC family
    and DDPG: raw actions inside (-0.999, 0.999), 10% terminals, replay
    weights."""
    from ray_tpu_torch.rllib.sample_batch import SampleBatch
    rng = np.random.default_rng(seed)
    b = SampleBatch({
        "obs": rng.standard_normal((n, 3)).astype(np.float32),
        "new_obs": rng.standard_normal((n, 3)).astype(np.float32),
        "raw_actions": rng.uniform(-0.999, 0.999, (n, 1)).astype(np.float32),
        "rewards": rng.standard_normal(n).astype(np.float32),
        "dones": rng.random(n) < 0.1,
        "weights": rng.uniform(0.2, 1.0, n).astype(np.float32)})
    if bc_weight is not None:
        b["_bc_weight"] = np.full((), bc_weight, np.float32)
    return b


def offpolicy_noise(kind, n=256, k=4, seed=SEED):
    """The draws one update takes, from numpy: SAC's (next, new), CQL's
    (with k uniform, policy and next-policy draws), CRR's (next and k
    policy draws), TD3's smoothing draw."""
    rng = np.random.default_rng(seed + 100)
    normal = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    if kind == "sac":
        return {"next": normal(n, 1), "new": normal(n, 1)}
    if kind == "cql":
        return {"next": normal(n, 1),
                "uniform": rng.uniform(-1, 1, (k, n, 1)).astype(np.float32),
                "pi": normal(k, n, 1), "next_pi": normal(k, n, 1),
                "new": normal(n, 1)}
    if kind == "crr":
        return {"next": normal(n, 1), "pi": normal(k, n, 1)}
    return normal(n, 1)


def offpolicy_learn_parity(device) -> dict:
    """Phase 17b: the card against the port's own CPU run, f32, TF32 off,
    at Pendulum's spaces with the default 256 x 256 nets and batch 256
    (policies built from one seed: the init draws on the CPU), numpy
    noise given to both: one SAC update; one DDPG and two TD3 learn steps
    (the second runs the delayed actor; replay weights in the batch);
    one CQL update in each phase (``_bc_weight`` 1, then 0); one CRR
    update per weight_type; one MARWIL update (Box actions, Monte Carlo
    returns). Stats (td_errors included), params, targets and log_alpha
    within PPO_F32 of their scale (``hold_learn``). The SAC family's pi
    head is scaled by 1/4 on both sides: at its own init the pre-tanh
    values reach ~16, where the card's and the CPU's tanh differ by an
    ulp and log(1 - tanh^2 + 1e-6) turns that into log-prob gaps that
    Adam's first step carries past PPO_F32. ``sac_own_init`` prints that
    case (one SAC update at the own init, not required): the pre-tanh
    range, the rows near saturation, the next action's log-prob gap and
    the update's gaps."""
    import torch
    from ray_tpu_torch.rllib import Box
    from ray_tpu_torch.rllib.algorithms import (CQLPolicy, CRRPolicy,
                                                DDPGConfig, DDPGPolicy,
                                                MARWILPolicy, SACPolicy,
                                                TD3Config)
    from ray_tpu_torch.rllib.algorithms.sac import _squash
    from ray_tpu_torch.rllib.policy import weights_of
    from ray_tpu_torch.rllib.sample_batch import SampleBatch
    spaces = (Box(-np.inf, np.inf, (3,)), Box(-2.0, 2.0, (1,)))

    def state(pol):
        """Host copies (a CPU policy's tensors change in place)."""
        out = dict(pol.get_weights())
        target = getattr(pol, "target_model", None)
        if target is not None:
            out.update({f"target.{k}": v for k, v in
                        weights_of(target).items()})
        if hasattr(pol, "log_alpha"):
            out["log_alpha"] = np.array(float(pol.log_alpha.detach()))
        return out

    def sac_family(cls, kind, batches, head_scale=4.0, **cfg):
        def run(dev):
            pol = cls(*spaces, dict(cfg, seed=SEED, device=dev))
            with torch.no_grad():
                for net in (pol.model, pol.target_model):
                    for p in net.pi_net[4].parameters():
                        p.div_(head_scale)
            return [(pol.learn_on_batch(b, offpolicy_noise(kind, seed=i)),
                     state(pol)) for i, b in enumerate(batches)]
        return run

    def sac_own_init():
        b, noise = offpolicy_batch(), offpolicy_noise("sac", seed=0)
        heads = {}
        for dev in ("cpu", device):
            pol = SACPolicy(*spaces, {"seed": SEED, "device": dev})
            with torch.no_grad():
                mean, log_std = pol.target_model.pi(
                    torch.tensor(b["new_obs"], device=dev))
                eps = torch.tensor(noise["next"], device=dev)
                act, logp = _squash(mean, log_std, eps)
                heads[dev] = [(mean + torch.exp(log_std) * eps).cpu().numpy(),
                              act.double().cpu().numpy(), logp.cpu().numpy()]
        gaps = learn_gaps(sac_family(SACPolicy, "sac", [b], 1.0)("cpu"),
                          sac_family(SACPolicy, "sac", [b], 1.0)(device))
        worst = max(gaps, key=gaps.get)
        pre, act, logp = heads["cpu"]
        res = {"max_abs_pre_tanh": float(np.max(np.abs(pre))),
               "rows_1m_a2_below_1e-5": int(np.sum(1 - act ** 2 < 1e-5)),
               "next_logp_max_abs_gap": float(np.max(np.abs(
                   heads[device][2] - logp))),
               "critic_loss_gap_of_scale": gaps["critic_loss"],
               "worst": worst, "worst_gap_of_scale": gaps[worst],
               "tol": PPO_F32}
        print("sac_own_init", json.dumps(res), flush=True)
        return res

    def ddpg(config_cls, steps):
        cfg = config_cls().to_dict()

        def run(dev):
            pol = DDPGPolicy(*spaces, dict(cfg, seed=SEED, device=dev))
            return [(pol.learn_on_batch(offpolicy_batch(seed=SEED + i),
                                        offpolicy_noise("td3", seed=i)),
                     state(pol)) for i in range(steps)]
        return run

    def marwil(dev):
        rng = np.random.default_rng(SEED)
        b = SampleBatch({
            "obs": rng.standard_normal((256, 3)).astype(np.float32),
            "actions": rng.uniform(-2, 2, (256, 1)).astype(np.float32),
            "returns": (30 * rng.standard_normal(256)).astype(np.float32)})
        pol = MARWILPolicy(*spaces, {"seed": SEED, "lr": 1e-4, "beta": 1.0,
                                     "device": dev})
        return [(pol.learn_on_batch(b), state(pol))]

    plain = [offpolicy_batch()]
    cases = (
        ("sac_learn_parity", sac_family(SACPolicy, "sac", plain)),
        ("ddpg_learn_parity", ddpg(DDPGConfig, 1)),
        ("td3_learn_parity", ddpg(TD3Config, 2)),
        ("cql_learn_parity", sac_family(
            CQLPolicy, "cql", [offpolicy_batch(bc_weight=1.0),
                               offpolicy_batch(seed=SEED + 1,
                                               bc_weight=0.0)])),
        ("crr_exp_learn_parity", sac_family(CRRPolicy, "crr", plain,
                                            weight_type="exp")),
        ("crr_binary_learn_parity", sac_family(CRRPolicy, "crr", plain,
                                               weight_type="binary")),
        ("marwil_learn_parity", marwil))
    out = {"sac_own_init": sac_own_init()}
    for tag, run in cases:
        out[tag] = hold_learn(tag, run("cpu"), run(device))
    require("actor_loss" in out["td3_learn_parity"]["stats_cuda"],
            "td3: the delayed actor did not run on the second step")
    return out


def offpolicy_phase(name, card) -> dict:
    """Phase 17: (b) the card against the CPU (SAC, DDPG, TD3, CQL, CRR
    and MARWIL updates), (a) SAC and TD3 on Pendulum through
    bench.sac_loop / bench.ddpg_loop and CQL, CRR, MARWIL and BC on the
    100,000-row Pendulum set through bench.offline_loop (written once),
    SAC's, TD3's and CQL's learn phases profiled, (c) no launch of the
    port's kernels across the phase."""
    import tempfile

    import torch
    from ray_tpu_torch import bench, kernels
    kernels.reset_launch_counts()
    offpolicy_learn_parity("cuda")

    def show(tag, r, key):
        profile = r.pop(key, None)
        print(tag, json.dumps({**r, "device": name, "nvidia_smi": card}),
              flush=True)
        if profile is not None:
            print(tag.replace("_train", "_profile"), json.dumps(profile),
                  flush=True)

    def prof(learn):
        return profile_step(learn, PPO_PROFILE_GROUPS)

    res = {}
    for p, r in (("sac", bench.sac_loop(profile=prof)),
                 ("td3", bench.ddpg_loop("TD3", profile=prof))):
        show(f"{p}_train", r, f"{p}_profile")
        require(r[f"{p}_hidden"] == 256 and r[f"{p}_train_batch_size"] == 256
                and r[f"{p}_iters_timed"] == 1000
                and r[f"{p}_replay_capacity"] == 100_000, f"{p} widths: {r}")
        require(r[f"{p}_losses_finite"], f"{p}: non-finite loss")
        require(r[f"{p}_weights_moved"] > 0, f"{p}: the weights did not move")
        require(r[f"{p}_replay_size"][1] > r[f"{p}_replay_size"][0],
                f"{p}: the buffer did not grow {r[f'{p}_replay_size']}")
        lo, hi = r[f"{p}_action_range"]
        require(-2.0 <= lo <= hi <= 2.0, f"{p}: actions outside the Box "
                f"{r[f'{p}_action_range']}")
        res[p] = r
    with tempfile.TemporaryDirectory() as data_dir:
        t0 = time.perf_counter()
        rows = bench.write_pendulum_dataset(data_dir)
        write_s = time.perf_counter() - t0
        for algo in ("CQL", "CRR", "MARWIL", "BC"):
            r = bench.offline_loop(algo, profile=prof if algo == "CQL"
                                   else None, data_dir=data_dir)
            r.update(offline_rows_written=rows, offline_write_s=write_s)
            show(f"offline_{algo.lower()}_train", r, "offline_profile")
            require(r["offline_rows"] == 100_000 and rows == 100_000
                    and r["offline_train_batch_size"] == 256,
                    f"{algo}: data or batch {r}")
            require(r["offline_losses_finite"], f"{algo}: non-finite loss")
            require(r["offline_weights_moved"] > 0,
                    f"{algo}: the weights did not move")
            if algo == "CQL":
                require(r["offline_learn_steps_total"] > r["offline_bc_iters"],
                        f"cql: never left its BC phase {r}")
            res[algo] = r
    launches = kernels.launch_counts()
    require(launches == {}, f"continuous and offline: the path launched "
            f"{launches}")
    torch.cuda.empty_cache()
    return res


def r2d2_batch(b=32, t=20, obs_dim=4, seed=SEED):
    """A fixed R2D2 batch at the default sequence shape: every fourth
    sequence padded past a random length, 5% terminals."""
    rng = np.random.default_rng(seed)
    mask = np.ones((b, t), np.float32)
    for i in range(0, b, 4):
        mask[i, rng.integers(5, t):] = 0.0
    return {"obs": rng.standard_normal((b, t, obs_dim)).astype(np.float32),
            "next_obs": rng.standard_normal((b, t, obs_dim)).astype(
                np.float32),
            "actions": rng.integers(2, size=(b, t)).astype(np.int64),
            "rewards": rng.standard_normal((b, t)).astype(np.float32),
            "dones": rng.random((b, t)) < 0.05, "mask": mask}


def hold_update(tag, cpu, card) -> dict:
    """One update on the card against the CPU, each (stats, weights,
    {"grad.<name>": grad}): stats and grads within PPO_F32 of their
    scale (``hold_learn``), params by ``hold_step``'s rule for Adam's
    first step: within PPO_F32 where the CPU step's |grad| passes
    PARAM_MASK or is 0 (a rounding-noise grad of a param whose true grad
    is 0 becomes a step of up to lr), the share of entries left out
    printed."""
    (cs, cw, cg), (ds, dw, dg) = cpu, card
    left = {}
    for n, w in cw.items():
        g = np.abs(cg[f"grad.{n}"])
        held = (g > PARAM_MASK) | (g == 0)
        dw[n] = np.where(held, dw[n], w)
        if not held.all():
            left[n] = int((~held).sum())
    res = hold_learn(tag, [(cs, {**cw, **cg})], [(ds, {**dw, **dg})])
    print(f"{tag}_params_left_out", json.dumps({
        "share": sum(left.values()) / sum(w.size for w in cw.values()),
        "by_param": left}), flush=True)
    return res


def local_learn_parity(device, data_dir) -> dict:
    """Phase 18b: the card against the port's own CPU run, f32, TF32 off,
    each algorithm at its JAX config's defaults and built from one seed
    (the init draws on the CPU): one R2D2 update on ``r2d2_batch`` (32
    x 20, LSTM 64); one DT update on a batch the CPU algorithm draws
    from the CartPole set in ``data_dir`` (64 x 24 tokens, width 64, 4
    heads, 2 layers); one SlateQ update on 128 rows of a replay filled
    by the CPU algorithm's random slates. Stats and grads within PPO_F32
    of their scale (``hold_learn``), and params by ``hold_step``'s rule
    for Adam's first step: within PPO_F32 where the CPU step's |grad|
    passes PARAM_MASK or is 0 (DT's key biases have a true grad of 0,
    as softmax ignores a shift common to a row, but a rounding-noise
    grad that Adam turns into a step of up to lr), the share of entries
    left out printed."""
    import torch
    from ray_tpu_torch.rllib.algorithms import (DTConfig, R2D2Config,
                                                SlateQConfig)
    from ray_tpu_torch.rllib.policy import stats_to_host, weights_of

    def build(config, dev):
        return config.resources(device=dev).debugging(seed=SEED).build()

    def run(algo, batch):
        stats = stats_to_host(algo._update(batch))
        return stats, weights_of(algo.model), {
            f"grad.{n}": p.grad.detach().cpu().numpy()
            for n, p in algo.model.named_parameters()}

    out = {}
    batch = r2d2_batch()
    cases = [("r2d2_learn_parity",
              lambda dev: build(R2D2Config().environment("CartPole-v1"), dev),
              lambda algo: batch)]
    dt_cfg = lambda: DTConfig().environment("CartPole-v1").offline_data(  # noqa: E731
        input_path=data_dir)
    dt_batch = build(dt_cfg(), "cpu")._sample_batch(64)
    cases.append(("dt_learn_parity", lambda dev: build(dt_cfg(), dev),
                  lambda algo: {k: v.to(algo.device)
                                for k, v in dt_batch.items()}))
    sq = build(SlateQConfig(), "cpu")
    sq._collect(300, 1.0)
    sq_batch = sq.replay.sample(128)
    cases.append(("slateq_learn_parity", lambda dev: build(SlateQConfig(),
                                                            dev),
                  lambda algo: sq_batch))
    for tag, make, feed in cases:
        res = []
        for dev in ("cpu", device):
            algo = make(dev)
            res.append(run(algo, feed(algo)))
        out[tag] = hold_update(tag, *res)
    require(tuple(dt_batch["obs"].shape) == (64, 8, 4)
            and tuple(batch["obs"].shape) == (32, 20, 4)
            and sq_batch.count == 128, "local parity shapes")
    torch.cuda.empty_cache()
    return out


def local_algos_phase(name, card) -> dict:
    """Phase 18: (b) the card against the CPU (R2D2, DT and SlateQ
    updates), (a) R2D2 on CartPole, SlateQ, DT on the offline CartPole
    set and the bandits through bench.r2d2_loop / slateq_loop / dt_loop /
    bandit_loop, R2D2's and SlateQ's learn phases and one DT iteration
    profiled, (c) no launch of the port's kernels across the phase."""
    import tempfile

    import torch
    from ray_tpu_torch import bench, kernels
    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as data_dir:
        bench.write_cartpole_dataset(data_dir, episodes=20)
        local_learn_parity("cuda", data_dir)

    def show(tag, r, key):
        profile = r.pop(key, None)
        print(tag, json.dumps({**r, "device": name, "nvidia_smi": card}),
              flush=True)
        if profile is not None:
            print(tag.replace("_train", "_profile"), json.dumps(profile),
                  flush=True)

    def prof(learn):
        return profile_step(learn, PPO_PROFILE_GROUPS)

    res = {}
    for p, loop in (("r2d2", bench.r2d2_loop), ("slateq", bench.slateq_loop)):
        r = loop(profile=prof)
        show(f"{p}_train", r, f"{p}_profile")
        require(r[f"{p}_losses_finite"], f"{p}: non-finite loss {r}")
        require(r[f"{p}_weights_moved"] > 0, f"{p}: the weights did not move")
        require(r[f"{p}_replay_size"][1] > r[f"{p}_replay_size"][0],
                f"{p}: the replay did not grow {r[f'{p}_replay_size']}")
        require(r[f"{p}_epsilon"][1] < r[f"{p}_epsilon"][0],
                f"{p}: epsilon did not fall {r[f'{p}_epsilon']}")
        require(r[f"{p}_target_syncs"] > 0
                and r[f"{p}_target_equals_online_after_sync"] is True,
                f"{p}: the target never synced {r}")
        res[p] = r
    require(res["r2d2"]["r2d2_lstm_size"] == 64
            and res["r2d2"]["r2d2_seq_len"] == 20
            and res["r2d2"]["r2d2_train_batch_size"] == 32,
            f"r2d2 widths: {res['r2d2']}")
    require(res["slateq"]["slateq_num_docs"] == 20
            and res["slateq"]["slateq_train_batch_size"] == 128,
            f"slateq widths: {res['slateq']}")
    d = bench.dt_loop(profile=prof)
    show("dt_train", d, "dt_profile")
    require(d["dt_embed_dim"] == 64 and d["dt_context_length"] == 8
            and d["dt_train_batch_size"] == 64 and d["dt_episodes"] == 120,
            f"dt widths: {d}")
    require(d["dt_losses_finite"], f"dt: non-finite loss {d['dt_action_nll']}")
    require(d["dt_weights_moved"] > 0, "dt: the weights did not move")
    res["dt"] = d
    b = bench.bandit_loop()
    print("bandit_train", json.dumps({**b, "device": "host (numpy)",
                                      "nvidia_smi": card}), flush=True)
    require(all(math.isfinite(v) for k, v in b.items()
                if k.endswith("_per_sec")), f"bandits: {b}")
    res["bandit"] = b
    launches = kernels.launch_counts()
    require(launches == {}, f"local algorithms: the path launched "
            f"{launches}")
    torch.cuda.empty_cache()
    return res


def multiagent_meta_parity(device) -> dict:
    """Phase 19b: the card against the port's own CPU run, f32, TF32 off,
    each algorithm at its JAX config's defaults and built from one seed
    (the init draws on the CPU): one QMIX update (64 rows, 2 agents)
    and one MADDPG update (128 rows, 2 agents, the stacked actors and
    critics), each on rows of a replay the CPU algorithm filled; one
    MAML meta-update over 10 tasks (second order) on pre/post batches of
    10 episodes x 20 steps the CPU algorithm collected; one MBMPO
    ensemble update (4 x 256 bootstrap rows of 16 real episodes) and,
    from the updated ensembles, one imagination (16 episodes x 20 steps,
    member 0) with fed noise. Updates by ``hold_update``; the
    imagination's batch and return within PPO_F32 of their scale."""
    import torch
    from ray_tpu_torch.rllib.algorithms import (MADDPGConfig, MAMLConfig,
                                                MBMPOConfig, QMixConfig)
    from ray_tpu_torch.rllib.policy import stats_to_host, weights_of

    def build(config, dev):
        return config.resources(device=dev).debugging(seed=SEED).build()

    def result(stats, model):
        return (stats_to_host(stats), weights_of(model), {
            f"grad.{n}": p.grad.detach().cpu().numpy()
            for n, p in model.named_parameters()})

    def on(dev, batches):
        return [{k: v.to(dev) for k, v in b.items()} for b in batches]

    out = {}
    qmix = lambda: QMixConfig().environment(  # noqa: E731
        "CoopCartPole", env_config={"num_agents": 2})
    maddpg = lambda: MADDPGConfig().environment(  # noqa: E731
        "MultiAgentTarget1D", env_config={"num_agents": 2})
    for tag, config, n, rows in (("qmix_learn_parity", qmix, 400, 64),
                                 ("maddpg_learn_parity", maddpg, 400, 128)):
        cpu = build(config(), "cpu")
        cpu._collect(n, 1.0 if tag.startswith("qmix") else 0.3)
        batch = cpu.replay.sample(rows)
        require(batch.count == rows, f"{tag}: {batch.count} rows")
        res = []
        for algo in (cpu, build(config(), device)):
            res.append(result(algo._update(batch), algo.model))
        out[tag] = hold_update(tag, *res)

    maml = build(MAMLConfig(), "cpu")
    pre, post = [], []
    for _ in range(maml.config["meta_batch_size"]):
        goal = maml.env.sample_task(maml._np_rng)
        b, _ = maml._collect_task(maml.params, goal)
        pre.append(b)
        post.append(maml._collect_task(maml._adapt(maml.params, b), goal)[0])
    require(len(pre) == 10 and tuple(pre[0]["obs"].shape) == (200, 2),
            "maml parity shapes")
    res = []
    for dev in ("cpu", device):
        algo = build(MAMLConfig(), dev)
        res.append(result(algo._meta_update(on(dev, pre), on(dev, post)),
                          algo.model))
    out["maml_meta_parity"] = hold_update("maml_meta_parity", *res)

    algos = [build(MBMPOConfig(), dev) for dev in ("cpu", device)]
    algos[0]._collect_real(algos[0].params, 16)
    data = algos[0]._bootstrap()
    require(data[0].shape == (4, 256, 2), f"mbmpo draws {data[0].shape}")
    res = [result({"model_loss": a._model_update(*data)}, a.dynamics)
           for a in algos]
    out["mbmpo_model_parity"] = hold_update("mbmpo_model_parity", *res)
    noise = np.random.default_rng(SEED).standard_normal(
        (20, 16, 2)).astype(np.float32)
    imag = []
    for a in algos:
        batch, ret = a._imagine(a.params, 0, noise=noise)
        imag.append(({"imagined_return": float(ret),
                      **{k: v.cpu().numpy() for k, v in batch.items()}}, {}))
    out["mbmpo_imagine_parity"] = hold_learn("mbmpo_imagine_parity",
                                             imag[:1], imag[1:])
    torch.cuda.empty_cache()
    return out


def multiagent_meta_phase(name, card) -> dict:
    """Phase 19: (b) the card against the CPU (QMIX, MADDPG, MAML, MBMPO),
    (a) bench.qmix_loop / maddpg_loop / maml_loop / mbmpo_loop, each
    with one learn phase profiled, (c) no launch of the port's kernels
    across the phase."""
    import torch
    from ray_tpu_torch import bench, kernels
    kernels.reset_launch_counts()
    multiagent_meta_parity("cuda")

    def prof(learn):
        return profile_step(learn, PPO_PROFILE_GROUPS)

    res = {}
    for p, loop in (("qmix", bench.qmix_loop), ("maddpg", bench.maddpg_loop),
                    ("maml", bench.maml_loop), ("mbmpo", bench.mbmpo_loop)):
        r = loop(profile=prof)
        profile = r.pop(f"{p}_profile")
        print(f"{p}_train", json.dumps({**r, "device": name,
                                        "nvidia_smi": card}), flush=True)
        print(f"{p}_profile", json.dumps(profile), flush=True)
        require(r[f"{p}_losses_finite"], f"{p}: non-finite loss {r}")
        require(r[f"{p}_weights_moved"] > 0, f"{p}: the weights did not move")
        res[p] = r
    for p in ("qmix", "maddpg"):
        r = res[p]
        require(r[f"{p}_replay_size"][1] > r[f"{p}_replay_size"][0],
                f"{p}: the replay did not grow {r[f'{p}_replay_size']}")
    q, m = res["qmix"], res["maddpg"]
    require(q["qmix_epsilon"][1] < q["qmix_epsilon"][0],
            f"qmix: epsilon did not fall {q['qmix_epsilon']}")
    require(q["qmix_target_syncs"] > 0
            and q["qmix_target_equals_online_after_sync"] is True,
            f"qmix: the target never synced {q}")
    require(m["maddpg_target_moved"] > 0, "maddpg: Polyak left the targets")
    mb = res["mbmpo"]
    require(mb["mbmpo_model_loss"][1] < mb["mbmpo_model_loss"][0],
            f"mbmpo: the trained ensemble's loss is not under the untrained "
            f"one's {mb['mbmpo_model_loss']}")
    require(mb["mbmpo_buffer_rows"][1] > mb["mbmpo_buffer_rows"][0],
            f"mbmpo: the buffer did not grow {mb['mbmpo_buffer_rows']}")
    require(q["qmix_agents"] == 2 and q["qmix_train_batch_size"] == 64
            and m["maddpg_agents"] == 2
            and m["maddpg_train_batch_size"] == 128
            and res["maml"]["maml_tasks"] == 10
            and res["maml"]["maml_env_steps_per_iter"] == 4000
            and mb["mbmpo_ensemble_size"] == 4
            and mb["mbmpo_model_train_iters"] == 60,
            f"multi-agent / meta widths: {res}")
    launches = kernels.launch_counts()
    require(launches == {}, f"multi-agent and meta algorithms: the path "
            f"launched {launches}")
    torch.cuda.empty_cache()
    return res


def model_based_parity(device) -> dict:
    """Phase 20b: the card against the port's own CPU run, f32, TF32 off,
    each algorithm built from one seed (the init draws on the CPU): one
    Dreamer update at ``DreamerConfig``'s defaults on 24 x 16 sequences
    that a CPU Dreamer collected on Pendulum (1,000 steps of noise 1.0),
    the update's Gaussian draws fed from numpy; one AlphaZero update of
    256 rows drawn from CPU self-play (TicTacToe at the defaults; Connect4
    from 2 games of 8 sims, its 84-wide obs); one AlphaStar update of
    main on its trajectory of one CPU game against the main exploiter;
    the first minibatch step (128 rows, the learn phase's order) of each
    policy of multi-agent PPO on one CPU sample of 512 env steps at
    ``bench.ma_ppo_config``'s widths. Each by ``hold_update``."""
    import torch
    from ray_tpu_torch import bench
    from ray_tpu_torch.rllib import synchronous_parallel_sample
    from ray_tpu_torch.rllib.algorithms import (AlphaStarConfig,
                                                AlphaZeroConfig,
                                                DreamerConfig, PPOConfig)
    from ray_tpu_torch.rllib.algorithms.alpha_star import MAIN
    from ray_tpu_torch.rllib.policy import stats_to_host, weights_of

    def build(config, dev):
        return config.resources(device=dev).debugging(seed=SEED).build()

    def result(stats, nets):
        """(stats, weights, grads) of ``nets`` {prefix: module}."""
        w, g = {}, {}
        for pre, net in nets.items():
            w.update({pre + k: v for k, v in weights_of(net).items()})
            g.update({f"grad.{pre}{n}": p.grad.detach().cpu().numpy()
                      for n, p in net.named_parameters()})
        return stats_to_host(stats), w, g

    out = {}
    rng = np.random.default_rng(SEED)
    cpu = build(DreamerConfig(), "cpu")
    cpu._collect(1000, 1.0)
    batch = cpu._sample_sequences()
    cfg = cpu.config
    T, B, H = cfg["seq_len"], cfg["batch_size"], cfg["imagine_horizon"]
    require(batch["obs"].shape == (24, 16, 3) and H == 10,
            f"dreamer parity shapes {batch['obs'].shape}")
    noise = {k: rng.standard_normal(shape).astype(np.float32)
             for k, shape in (("obs", (T, B, 8)), ("act", (H, B * T, 1)),
                              ("latent", (H, B * T, 8)))}
    res = []
    for dev in ("cpu", device):
        algo = build(DreamerConfig(), dev)
        stats = algo._update(batch, {k: torch.from_numpy(v)
                                     for k, v in noise.items()})
        res.append(result(stats, {f"{k}.": getattr(algo, k)
                                  for k in ("wm", "actor", "value")}))
    out["dreamer_learn_parity"] = hold_update("dreamer_learn_parity", *res)

    for game, over in (("tictactoe", {}),
                       ("connect4", {"games_per_iteration": 2,
                                     "num_sims": 8})):
        cpu = build(AlphaZeroConfig().environment(game).training(**over),
                    "cpu")
        for _ in range(cpu.config["games_per_iteration"]):
            cpu._replay.extend(cpu._self_play_game()[0])
        idx = rng.integers(0, len(cpu._replay), 256)
        rows = [np.stack([cpu._replay[i][j] for i in idx]) for j in (0, 1)]
        z = np.asarray([cpu._replay[i][2] for i in idx], np.float32)
        require(rows[0].shape == (256, 18 if game == "tictactoe" else 84),
                f"alphazero parity shapes {rows[0].shape}")
        res = []
        for dev in ("cpu", device):
            algo = build(AlphaZeroConfig().environment(game).training(
                **over), dev)
            res.append(result(algo._update(rows[0], rows[1], z),
                              {"": algo.model}))
        tag = f"alphazero_{game}_learn_parity"
        out[tag] = hold_update(tag, *res)

    cpu = build(AlphaStarConfig(), "cpu")
    _, traj, _ = cpu._play_game(cpu.league[MAIN].params,
                                cpu.league["main_exploiter_0"].params)
    obs = np.stack([o for o, _ in traj])
    acts = np.array([a for _, a in traj], np.int64)
    rets = np.full(len(traj), 1.0, np.float32)
    res = []
    for dev in ("cpu", device):
        algo = build(AlphaStarConfig(), dev)
        net = algo.league[MAIN].params
        loss = algo._update(net, algo._opt_states[MAIN], obs, acts, rets)
        res.append(result({"loss": loss}, {"": net}))
    out["alphastar_learn_parity"] = hold_update("alphastar_learn_parity",
                                                *res)

    full = dict(bench.ma_ppo_config(device).to_dict(), device="cpu")
    cpu = PPOConfig().update_from_dict(full).build()
    sample = synchronous_parallel_sample(cpu.workers, max_env_steps=512)
    require(sample.env_steps() >= 512 and len(sample.policy_batches) == 2,
            f"ma_ppo parity sample {sample.env_steps()}")
    algos = [cpu, PPOConfig().update_from_dict(
        dict(full, device=device)).build()]
    for pid, b in sorted(sample.policy_batches.items()):
        mb = next(iter(b.minibatches(
            128, rng=np.random.default_rng(full["seed"]))))
        res = []
        for algo in algos:
            pol = algo.get_policy(pid)
            res.append(result({k: torch.tensor(v) for k, v in
                               pol.learn_on_batch(mb).items()},
                              {"": pol.model}))
        tag = f"ma_ppo_{pid}_learn_parity"
        out[tag] = hold_update(tag, *res)
    for algo in algos:
        algo.cleanup()
    torch.cuda.empty_cache()
    return out


def model_based_phase(name, card) -> dict:
    """Phase 20: (b) the card against the CPU (Dreamer, AlphaZero,
    AlphaStar, multi-agent PPO), (a) bench.dreamer_loop /
    alphazero_loop / alphastar_loop / ma_ppo_loop, each with one learn
    phase profiled, (c) no launch of the port's kernels across the
    phase."""
    import torch
    from ray_tpu_torch import bench, kernels
    kernels.reset_launch_counts()
    model_based_parity("cuda")

    def prof(learn):
        return profile_step(learn, PPO_PROFILE_GROUPS)

    res = {}
    for p, loop in (("dreamer", bench.dreamer_loop),
                    ("alphazero", bench.alphazero_loop),
                    ("alphastar", bench.alphastar_loop),
                    ("ma_ppo", bench.ma_ppo_loop)):
        r = loop(profile=prof)
        profile = r.pop(f"{p}_profile")
        print(f"{p}_train", json.dumps({**r, "device": name,
                                        "nvidia_smi": card}), flush=True)
        print(f"{p}_profile", json.dumps(profile), flush=True)
        require(r[f"{p}_losses_finite"], f"{p}: non-finite loss {r}")
        require(r[f"{p}_weights_moved"] > 0, f"{p}: the weights did not move")
        res[p] = r
    d, z, a, m = (res[k] for k in ("dreamer", "alphazero", "alphastar",
                                   "ma_ppo"))
    require(d["dreamer_recon_loss"][1] < d["dreamer_recon_loss"][0],
            f"dreamer: the held batch's reconstruction loss did not fall "
            f"{d['dreamer_recon_loss']}")
    require(a["alphastar_num_historical"][0] == 0
            and a["alphastar_num_historical"][1] >= 1,
            f"alphastar: no snapshot in the timed window "
            f"{a['alphastar_num_historical']}")
    require(a["alphastar_snapshot_gap"] > 0,
            "alphastar: the snapshot followed main")
    require(m["ma_ppo_policies"] == ["pol_a", "pol_b"],
            f"ma_ppo: learner info {m['ma_ppo_policies']}")
    require((d["dreamer_deter_size"], d["dreamer_stoch_size"],
             d["dreamer_hidden"], d["dreamer_batch_size"],
             d["dreamer_seq_len"], d["dreamer_imagine_horizon"],
             d["dreamer_prefill_steps"], d["dreamer_env_steps_per_iter"],
             d["dreamer_updates_per_iter"])
            == (64, 8, 64, 24, 16, 10, 1000, 200, 20)
            and (z["alphazero_games_per_iter"], z["alphazero_num_sims"],
                 z["alphazero_train_batch_size"], z["alphazero_sgd_iters"],
                 z["alphazero_hidden"]) == (24, 25, 256, 8, 128)
            and (a["alphastar_matches_per_iter"], a["alphastar_hidden"],
                 a["alphastar_snapshot_interval"]) == (64, 64, 10)
            and (m["ma_ppo_train_batch_size"], m["ma_ppo_sgd_minibatch_size"],
                 m["ma_ppo_num_sgd_iter"]) == (512, 128, 6),
            f"model-based / multi-agent widths: {res}")
    launches = kernels.launch_counts()
    require(launches == {}, f"model-based and multi-agent algorithms: the "
            f"path launched {launches}")
    torch.cuda.empty_cache()
    return res


def same_bytes(a, b) -> bool:
    """Tensors of one dtype and shape with the same bytes."""
    import torch
    if b is None:
        return False
    b = b.to(a.device)
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.detach().reshape(-1).view(torch.uint8),
        b.detach().reshape(-1).view(torch.uint8)))


def checkpoint_phase(name, card) -> dict:
    """Phase 21a: GPT-2 small at 16 x 1024 through
    make_causal_lm_trainer: 2 steps, an async save of the state, 2 more
    steps while the writer runs; a fresh init from another seed restored
    from the manager runs the same 2 batches: losses and grad norms
    within CKPT_RESUME_REL of the uninterrupted run's, params and
    moments byte-equal to the state at the save, step 2; 3 saves leave 2
    committed steps (num_to_keep 2), each verified; the whole-kv kernels
    launched 12 times each a step (phase 6's). Then bench.ckpt_loop."""
    import shutil
    import tempfile

    import torch
    from ray_tpu_torch import bench, kernels
    from ray_tpu_torch.checkpoint import AsyncCheckpointer, CheckpointManager
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.train import spmd

    cfg = GPT2Config.small()
    require(cfg == bench.gpt2_train_shape(torch.device("cuda"))[0],
            "phase 21a's config is not phase 6's")
    trainer = spmd.make_causal_lm_trainer(cfg)
    rng = np.random.default_rng(SEED + 21)
    batches = [spmd.put_batch(trainer, {"input_ids": t, "labels": t})
               for t in (rng.integers(0, cfg.vocab_size, (16, 1024))
                         for _ in range(5))]

    def run(st, bs):
        out = []
        for b in bs:
            st, m = trainer.step(st, b)
            out.append({k: float(v) for k, v in m.items()})
        return out

    root = tempfile.mkdtemp(prefix="ckpt_phase21_")
    try:
        kernels.reset_launch_counts()
        state = trainer.init(SEED)
        first = run(state, batches[:2])
        mgr = CheckpointManager(root, num_to_keep=2)
        ck = AsyncCheckpointer(mgr)
        saved = spmd.gather_state(state)        # on the card
        ck.save(state["step"], state)
        ref = run(state, batches[2:4])          # the writer runs
        overlapped = ck.in_flight()
        ck.wait()
        save = ck.stats[-1].as_dict()
        t0 = time.perf_counter()
        restored = spmd.restore_spmd_state(trainer.init(SEED + 1),
                                           manager=mgr)
        restore_s = time.perf_counter() - t0
        require(restored["step"] == 2, f"restored step {restored['step']}")
        back = spmd.gather_state(restored)
        bad = [n for n in saved["model"]
               if not same_bytes(saved["model"][n], back["model"][n])]
        bad += [f"{n}/{k}" for n, st in saved["opt"].items()
                for k, v in st.items()
                if not same_bytes(v, back["opt"][n].get(k))]
        require(not bad and set(saved["opt"]) == set(back["opt"]),
                f"restored state differs from the saved one: {bad[:5]}")
        del saved, back
        got = run(restored, batches[2:4])
        gap = max(abs(g[k] - r[k]) / abs(r[k]) for g, r in zip(got, ref)
                  for k in r)
        require(gap <= CKPT_RESUME_REL,
                f"resumed steps {got} against uninterrupted {ref}")
        ck.save(state["step"], state)           # step 4
        run(restored, batches[4:5])
        ck.save(restored["step"], restored)     # step 5
        ck.finalize()
        committed = mgr.committed_steps()
        require(committed == [4, 5], f"committed steps {committed}")
        require(all(mgr.verify_step(s) for s in committed),
                "a committed step failed verification")
        counts = kernels.launch_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    n_steps = 7
    for kname in ("whole_attention_forward", "whole_attention_backward",
                  "attention_delta"):
        require(counts.get(kname, 0) == cfg.n_layer * n_steps,
                f"{kname} launched {counts.get(kname, 0)} times in "
                f"{n_steps} steps of {cfg.n_layer} layers")
    res = {"model": "gpt2-small", "batch": 16, "seq_len": 1024,
           "losses": [m["loss"] for m in first + ref],
           "resumed": got, "uninterrupted": ref, "resume_rel_gap": gap,
           "bit_equal": gap == 0.0, "save": save,
           "write_overlapped_two_steps": overlapped, "restore_s": restore_s,
           "committed": committed, "launches": counts, "steps": n_steps,
           "device": name, "nvidia_smi": card}
    print("checkpoint", json.dumps(res), flush=True)
    del state, restored, trainer, batches
    torch.cuda.empty_cache()
    c = bench.ckpt_loop()
    print("ckpt_loop", json.dumps({**c, "device": name, "nvidia_smi": card}),
          flush=True)
    require(c["ckpt_async_blocked_ms_per_save"]
            < c["ckpt_sync_blocked_ms_per_save"],
            f"async saves blocked no less than sync ones: {c}")
    torch.cuda.empty_cache()
    return {"checkpoint": res, "ckpt_loop": c}


def near_tie(prompt, want, got) -> dict:
    """Where stream ``got`` first leaves ``want`` (both greedy from
    ``prompt`` through phase 4's GPT-2 small): the position, the two
    tokens, the f32 model's logit margin between them there and the bf16
    model's largest logit error against it there (one-row forwards of
    the prompt and the common tokens)."""
    import torch
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve.llm.model_runner import build_model
    j = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    cfg, m16 = build_model("gpt2", gpt2.GPT2Config.small(), seed=SEED)
    m32 = gpt2.GPT2(dataclasses.replace(cfg, dtype=torch.float32,
                                        attention_backend="reference"))
    m32.load_state_dict(m16.state_dict())
    m32 = m32.cuda().eval()
    ids = torch.as_tensor([prompt + want[:j]], device="cuda")
    with torch.no_grad():
        l32 = m32(ids)[0, -1].double()
        l16 = m16(ids)[0, -1].double()
    out = {"position": j, "phase4_token": want[j], "disagg_token": got[j],
           "margin_f32": abs(float(l32[want[j]] - l32[got[j]])),
           "bf16_err": float((l16 - l32).abs().max())}
    del m16, m32
    torch.cuda.empty_cache()
    return out


def disagg_phase(name, card, unified) -> dict:
    """Phase 21b: bench.disagg_loop on phase 4's prompts and weights
    (GPT-2 small, 64 greedy tokens): two LLMServers, the prefill one's
    __llm_prefill__ then the decode one's __llm_adopt__. Each prompt
    alone gives the same tokens through the two hops as unified; run
    concurrently, each stream's tokens equal ``unified``'s (phase 4's)
    or leave them at a near-tie (NEAR_TIE_FACTOR); every handoff
    adopted; the prefill server decodes no step and the
    paged-decode kernel takes every layer of the decode server's every
    decode step; both pools end at 0 used pages; the corrupted frame is
    re-prefilled (adopted False) to the tokens of its prompt alone."""
    import torch
    from ray_tpu_torch import bench
    r = bench.disagg_loop(prompts=unified["prompts"], new_tokens=64)
    want = unified["tokens"]
    differ = [i for i, t in enumerate(r["disagg_tokens"]) if t != want[i]]
    unified_differ = [i for i, t in enumerate(r["disagg_unified_tokens"])
                      if t != want[i]]
    solo_differ = [i for i, (a, b) in enumerate(zip(
        r["disagg_solo_tokens"], r["disagg_solo_unified_tokens"])) if a != b]
    ties = [near_tie(unified["prompts"][i], want[i], r["disagg_tokens"][i])
            for i in differ]
    steps, launches = r["disagg_decode_steps"], r["disagg_paged_decode_launches"]
    res = {k: v for k, v in r.items() if not k.endswith("tokens")}
    res.update({"prompts_differing_from_phase4": differ,
                "divergences": ties,
                "unified_rerun_differing_from_phase4": unified_differ,
                "solo_differing": solo_differ,
                "device": name, "nvidia_smi": card})
    print("disagg", json.dumps(res), flush=True)
    require(not solo_differ and all(r["disagg_solo_adopted"]),
            f"alone, the two hops gave other tokens than unified on prompts "
            f"{solo_differ} (adopted {r['disagg_solo_adopted']})")
    for t in ties:
        require(t["margin_f32"] <= NEAR_TIE_FACTOR * t["bf16_err"],
                f"a disaggregated stream left phase 4's at no near-tie: {t}")
    require(all(r["disagg_adopted"]), f"handoffs not adopted: "
            f"{r['disagg_adopted']}")
    require(steps["prefill"] == 0 and steps["decode"] > 0
            and launches == r["disagg_n_layer"] * steps["decode"],
            f"paged_attention_decode launched {launches} times over "
            f"{steps} decode steps of {r['disagg_n_layer']} layers")
    require(r["disagg_pages_used_at_end"] == {"prefill": 0, "decode": 0},
            f"pages left in use: {r['disagg_pages_used_at_end']}")
    require(not r["disagg_reprefill_adopted"]
            and r["disagg_reprefill_tokens"]
            == r["disagg_solo_unified_tokens"][0],
            "the corrupted frame was not re-prefilled to the same tokens")
    torch.cuda.empty_cache()
    return res


def serve_runtime_phase(name, card, phase4) -> dict:
    """Phase 25 (module docstring): bench.serve_loop on phase 4's
    prompts, held to phase 4's tokens alone and concurrent. Returns the
    printed measurements."""
    import gc
    import torch
    from ray_tpu_torch import bench, kernels

    gc.collect()
    torch.cuda.empty_cache()
    built = {n: kernels._lib_path(n) for n in kernels.sources()}
    mtimes = {n: os.path.getmtime(p) for n, p in built.items()}
    t0 = time.perf_counter()
    r = bench.serve_loop(prompts=phase4["prompts"], new_tokens=64)
    phase_s = time.perf_counter() - t0
    start, probe = r["serve_probe_at_start"], r["serve_probe"]
    require(start["gpu_ids"] == [0] and start["cuda_visible_devices"] == "0"
            and start["device"] == "cuda", f"the replica's grant: {start}")
    loaded = probe["kernel_libraries"]
    require("paged_decode" in loaded
            and all(built.get(n) == path for n, path in loaded.items()),
            f"the replica loaded {loaded}, not phase 2's {built}")
    rebuilt = [n for n, p in built.items() if os.path.getmtime(p) != mtimes[n]]
    require(not rebuilt,
            f"kernel libraries rebuilt during phase 25: {rebuilt}")
    alone_differ = [i for i, (a, b) in enumerate(zip(
        r["serve_alone_tokens"], phase4["alone_tokens"])) if a != b]
    require(len(r["serve_alone_tokens"]) == len(phase4["alone_tokens"])
            and not alone_differ,
            f"alone through the handle, prompts {alone_differ} gave other "
            "tokens than phase 4's server alone")
    require(all(s == 200 for s in r["serve_stream_status"])
            and not any(r["serve_stream_errors"]),
            f"SSE streams: {r['serve_stream_status']} "
            f"{r['serve_stream_errors']}")
    require(all(r["serve_first_event_before_done"]),
            "an SSE stream's first event did not come before its [DONE]")
    want = phase4["tokens"]
    streams = r["serve_stream_tokens"]
    require(all(len(t) == 64 for t in streams),
            f"SSE stream lengths {[len(t) for t in streams]}")
    differ = [i for i, t in enumerate(streams) if t != want[i]]
    ties = [near_tie(phase4["prompts"][i], want[i], streams[i])
            for i in differ]
    for t in ties:
        require(t["margin_f32"] <= NEAR_TIE_FACTOR * t["bf16_err"],
                f"an SSE stream left phase 4's at no near-tie: {t}")
    require(r["serve_unary_post_tokens"] == r["serve_alone_tokens"][0],
            "the unary POST gave other tokens than the handle")
    steps, launches = r["serve_decode_steps"], r["serve_paged_decode_launches"]
    require(steps > 0 and launches == r["serve_n_layer"] * steps,
            f"replica: paged_attention_decode launched {launches} times "
            f"over {steps} decode steps of {r['serve_n_layer']} layers")
    require(r["serve_pages_used_at_end"] == 0,
            f"the replica's pool holds {r['serve_pages_used_at_end']} pages")
    require(r["serve_gpu_task_after_shutdown"] == [0],
            f"after serve.shutdown a num_gpus=1 task got "
            f"{r['serve_gpu_task_after_shutdown']}")
    res = {k: v for k, v in r.items() if not k.endswith("tokens")}
    res.update({
        "phase_s": phase_s,
        "streams_differing_from_phase4": differ, "divergences": ties,
        "serve_vs_inprocess": {
            "tokens_per_s": r["serve_tokens_per_s"] / phase4["tokens_per_s"],
            "inprocess_tokens_per_s": phase4["tokens_per_s"],
            "inprocess_ttft_p50_s": phase4["ttft_p50_s"],
            "inprocess_ttft_p99_s": phase4["ttft_p99_s"],
            "inprocess_engine_itl_p50_s": phase4["engine_itl_p50_s"],
            "inprocess_engine_itl_p99_s": phase4["engine_itl_p99_s"],
            "replica_engine": probe["engine"]},
        "device": name, "nvidia_smi": card})
    print("serve_runtime", json.dumps(res), flush=True)
    print("serve_runtime_bypassed", json.dumps({
        "two_hop_disaggregation": "needs two GPU-granted replicas; this "
        "machine has one GPU (held on the CPU by "
        "tests/test_torch_serve_llm.py)"}), flush=True)
    torch.cuda.empty_cache()
    return res


def gpt2_steps(n: int) -> dict:
    """``n`` steps of phase 6's GPT-2 small trainer (bench.gpt2_loop's
    configuration, init(0), its 16 x 1024 batch from its seed) in this
    process: losses, grad norms, each step's host time (closed by the
    loss's read), the kernels' launch counts over the steps."""
    import torch
    from ray_tpu_torch import bench, kernels
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.train.spmd import make_causal_lm_trainer, put_batch
    dev = torch.device("cuda")
    cfg, batch, seq = bench.gpt2_train_shape(dev)
    trainer = make_causal_lm_trainer(cfg, spec=MeshSpec(dp=1), device=dev)
    state = trainer.init(0)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq), dtype=np.int32)
    resident = put_batch(trainer, {"input_ids": tokens, "labels": tokens})
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    losses, norms, ms = [], [], []
    for _ in range(n):
        t0 = time.perf_counter()
        m = trainer.step(state, resident)[1]
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launch_counts()
    del trainer, state, resident
    torch.cuda.empty_cache()
    return {"losses": losses, "grad_norms": norms, "step_ms": ms,
            "launches": counts, "n_layer": cfg.n_layer}


def _gpu_process_info() -> dict:
    import torch
    import ray_tpu_torch
    return {"gpu_ids": ray_tpu_torch.get_gpu_ids(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device_count": torch.cuda.device_count(),
            "device": torch.cuda.get_device_name(0), "pid": os.getpid()}


class RuntimeTrainActor:
    """Phase 22's first actor (``num_gpus=1``): phase 6's trainer in a
    worker process, with the kernels built by phase 2 loaded."""

    def __init__(self):
        t0 = time.perf_counter()
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.init()
        self.init_s = time.perf_counter() - t0

    def info(self) -> dict:
        from ray_tpu_torch import kernels
        # every library phase 2 built is there to load: none is rebuilt
        missing = [n for n in kernels.sources()
                   if not os.path.exists(kernels._lib_path(n))]
        return {**_gpu_process_info(), "import_and_cuda_init_s": self.init_s,
                "kernel_libraries_missing": missing}

    def train(self, n: int) -> dict:
        return gpt2_steps(n)

    def ping(self):
        return None


class RuntimeServeActor:
    """Phase 22's second actor (``num_gpus=1``): an LLMServer on phase
    4's weights (its config, its seed, its engine) in a worker process."""

    def __init__(self):
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.server = phase4_server()

    def info(self) -> dict:
        return _gpu_process_info()

    def serve_alone(self, prompts, new_tokens: int) -> dict:
        return serve_alone(self.server, prompts, new_tokens)

    def close(self):
        self.server.engine.stop()


def phase4_server():
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve.llm import LLMServer
    return LLMServer(
        model="gpt2", model_config={"config": gpt2.GPT2Config.small(),
                                    "seed": SEED},
        engine_config={"max_running": 16, "max_seq_len": 1024,
                       "block_size": 16, "num_blocks": 1025})


def serve_alone(server, prompts, new_tokens: int) -> dict:
    """Each prompt alone through ``server`` (serve_streams of one):
    tokens per prompt, the paged-decode kernel's launches and the decode
    steps, summed."""
    tokens, launches, steps = [], 0, 0
    for p in prompts:
        results, _, n_launch, n_steps = serve_streams(server, [p],
                                                      new_tokens)
        tokens.append(results[0][0])
        launches += n_launch
        steps += n_steps
    return {"tokens": tokens, "launches": launches, "decode_steps": steps,
            "n_layer": server.adapter.model.cfg.n_layer}


def _noop():
    return None


def _cpu_task_view() -> dict:
    import torch
    return {"cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "cuda_available": torch.cuda.is_available(),
            "gpu_ids": __import__("ray_tpu_torch").get_gpu_ids()}


def _maps_hold(pid: int, names) -> list:
    with open(f"/proc/{pid}/maps") as f:
        maps = f.read()
    return [n for n in names if n in maps]


def _median_ms(fn, n: int) -> float:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def runtime_phase(name, card, prompts) -> dict:
    """Phase 22 (module docstring): the runtime on this machine, with the
    GPU granted by index to a training actor and then a serving one.
    ``prompts``: phase 4's prompts, of which the first RUNTIME_PROMPTS
    are served. Returns the printed measurements and the launch counts
    of the two actors' paths."""
    import gc
    import torch
    import ray_tpu_torch as rt

    gc.collect()
    torch.cuda.empty_cache()
    driver_mem = {"memory_reserved_bytes": torch.cuda.memory_reserved(),
                  "memory_allocated_bytes": torch.cuda.memory_allocated()}
    print("runtime_driver_memory", json.dumps(driver_mem), flush=True)
    shm = os.statvfs("/dev/shm") if os.path.isdir("/dev/shm") else None
    shm_free = shm.f_bavail * shm.f_frsize if shm else None
    # the store must hold the 256 MB put with room to spare
    store_bytes = 2 << 30 if shm_free is None else min(2 << 30,
                                                       shm_free // 2)
    require(store_bytes >= 640 << 20,
            f"/dev/shm has {shm_free} B free: too little for the store")

    out = {"device": name, "nvidia_smi": card, "dev_shm_free_bytes":
           shm_free, "object_store_bytes": store_bytes, **driver_mem}
    # the driver's reference: the same steps and the same prompts alone
    here = gpt2_steps(RUNTIME_STEPS)
    server = phase4_server()
    try:
        here_serve = serve_alone(server, prompts[:RUNTIME_PROMPTS], 64)
    finally:
        server.engine.stop()
    del server
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rt.init(num_cpus=4, object_store_memory=store_bytes)
    out["init_s"] = time.perf_counter() - t0
    try:
        res = rt.cluster_resources()
        require(res.get("GPU") == 1.0, f"cluster_resources: {res}")
        procs = rt._node_processes
        for label, proc in (("gcs", procs.gcs_proc),
                            ("raylet", procs.raylet_proc)):
            loaded = _maps_hold(proc.pid, ("libtorch", "libcuda",
                                           "libc10"))
            require(not loaded, f"the {label} process loaded {loaded}")

        cpu = rt.get(rt.remote(num_gpus=0)(_cpu_task_view).remote(),
                     timeout=120)
        require(cpu == {"cuda_visible_devices": "", "cuda_available": False,
                        "gpu_ids": []}, f"a num_gpus=0 task saw {cpu}")

        t0 = time.perf_counter()
        trainer = rt.remote(num_gpus=1)(RuntimeTrainActor).remote()
        info = rt.get(trainer.info.remote(), timeout=300)
        out["gpu_worker_start_s"] = time.perf_counter() - t0
        out["gpu_worker_import_and_cuda_init_s"] = \
            info["import_and_cuda_init_s"]
        require(info["gpu_ids"] == [0]
                and info["cuda_visible_devices"] == "0"
                and info["device_count"] == 1,
                f"the GPU actor's grant: {info}")
        require(not info["kernel_libraries_missing"],
                f"kernel libraries missing in the worker: {info}")
        rt.get(trainer.ping.remote())
        out["actor_call_ms_p50"] = _median_ms(
            lambda: rt.get(trainer.ping.remote()), 200)
        noop = rt.remote(_noop)
        rt.get(noop.remote())
        out["task_round_trip_ms_p50"] = _median_ms(
            lambda: rt.get(noop.remote()), 200)

        there = rt.get(trainer.train.remote(RUNTIME_STEPS), timeout=600)
        n_layer = here["n_layer"]
        require(there["losses"] == here["losses"]
                and there["grad_norms"] == here["grad_norms"],
                f"the actor's steps differ from the driver's: "
                f"{there['losses']} {there['grad_norms']} vs "
                f"{here['losses']} {here['grad_norms']}")
        for kname in ("whole_attention_forward", "whole_attention_backward",
                      "attention_delta"):
            for who, r in (("actor", there), ("driver", here)):
                got = r["launches"].get(kname, 0)
                require(got == n_layer * RUNTIME_STEPS,
                        f"{who}: {kname} launched {got} times in "
                        f"{RUNTIME_STEPS} steps of {n_layer} layers")

        # the second GPU actor waits for the card
        serve = rt.remote(num_gpus=1)(RuntimeServeActor).remote()
        serve_info = serve.info.remote()
        ready, _ = rt.wait([serve_info], num_returns=1, timeout=10)
        queued_gpus = rt.available_resources().get("GPU", 0.0)
        require(not ready and queued_gpus == 0.0,
                f"the serving actor started while the GPU was held "
                f"(ready {bool(ready)}, GPU available {queued_gpus})")
        t0 = time.perf_counter()
        rt.kill(trainer)
        sinfo = rt.get(serve_info, timeout=300)
        out["serve_actor_start_after_kill_s"] = time.perf_counter() - t0
        require(sinfo["gpu_ids"] == [0]
                and sinfo["cuda_visible_devices"] == "0",
                f"the serving actor's grant: {sinfo}")
        served = rt.get(serve.serve_alone.remote(
            prompts[:RUNTIME_PROMPTS], 64), timeout=600)
        rt.get(serve.close.remote())
        rt.kill(serve)
        require(served["tokens"] == here_serve["tokens"],
                "the serving actor's tokens differ from this process's on "
                "the same prompts alone")
        require(served["decode_steps"] > 0
                and served["launches"] == served["n_layer"]
                * served["decode_steps"],
                f"serving actor: paged_attention_decode launched "
                f"{served['launches']} times over {served['decode_steps']} "
                f"decode steps")

        # host numbers: the object store with tensors
        big = torch.randint(0, 1 << 30, (64 << 20,), dtype=torch.int32)
        t0 = time.perf_counter()
        ref = rt.put(big)
        put_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = rt.get(ref)
        get_s = time.perf_counter() - t0
        require(torch.equal(back, big), "256 MB CPU tensor changed")
        del ref, back
        # again, into store pages the first put has already touched
        t0 = time.perf_counter()
        ref = rt.put(big)
        put_again_s = time.perf_counter() - t0
        require(torch.equal(rt.get(ref), big), "256 MB CPU tensor changed")
        del ref
        dev_t = torch.randn(4096, 2048, device="cuda").to(torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = rt.put(dev_t)
        cput_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        dback = rt.get(ref)
        torch.cuda.synchronize()
        cget_s = time.perf_counter() - t0
        require(dback.device.type == "cuda" and dback.dtype == torch.bfloat16
                and torch.equal(dback, dev_t),
                "16 MB bf16 CUDA tensor changed")
        del ref, dback, dev_t, big
        out.update({
            "put_256mb_cpu_s": put_s, "get_256mb_cpu_s": get_s,
            "put_256mb_cpu_again_s": put_again_s,
            "put_cpu_gb_per_s": (256 << 20) / put_s / 1e9,
            "put_again_cpu_gb_per_s": (256 << 20) / put_again_s / 1e9,
            "get_cpu_gb_per_s": (256 << 20) / get_s / 1e9,
            "put_16mb_bf16_cuda_s": cput_s, "get_16mb_bf16_cuda_s": cget_s,
            "losses": there["losses"], "grad_norms": there["grad_norms"],
            "actor_step_ms": there["step_ms"],
            "driver_step_ms": here["step_ms"],
            "actor_train_launches": there["launches"],
            "serve_decode_steps": served["decode_steps"],
            "serve_paged_decode_launches": served["launches"],
            "served_prompt_tokens": [len(p) for p in
                                     prompts[:RUNTIME_PROMPTS]],
            "tokens_equal_driver_alone": True, "bit_equal_steps": True})
    finally:
        rt.shutdown()
    torch.cuda.empty_cache()
    print("runtime", json.dumps(out), flush=True)
    return {**out, "train_launches": there["launches"],
            "serve_launches": served["launches"]}


def framework_phase(name, card, phase6, phase11) -> dict:
    """Phase 23 (module docstring): the headline bench's framework path
    on this card, held to the driver's items and to phase 6's GPT-2
    steps. ``phase6``: bench.gpt2_loop's result in this process;
    ``phase11``: phase 11's raw ResNet-50 numbers. Returns the worker's
    GPT-2 launch counts."""
    import gc
    import hashlib
    import torch
    from ray_tpu_torch import bench
    from ray_tpu_torch.models import gpt2

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fw = bench.framework_main()
    phase_s = time.perf_counter() - t0
    require("gpt2_error" not in fw, f"framework: {fw.get('gpt2_error')}")
    missing = [k for k in ("gpt2_losses", "gpt2_grad_norms",
                           "gpt2_launches", "gpt2_steps_timed",
                           "gpt2_step_time_ms") if k not in fw]
    require(not missing, f"framework: no {missing} in the worker's report")
    require(fw["gpu_ids"] == [0] and fw["platform"] == "cuda",
            f"framework: the worker's grant {fw['gpu_ids']}, platform "
            f"{fw['platform']}")
    n = fw["batch_per_chip"]
    items = bench.framework_items(fw["framework_n_images"],
                                  fw["framework_image_size"])
    want = hashlib.sha256(np.stack([it["image"] for it in items[:n]])
                          .tobytes()).hexdigest()
    require(fw["first_batch_image_sha256"] == want
            and fw["first_batch_labels"] == [int(it["label"])
                                             for it in items[:n]],
            "framework: the first device batch is not the driver's first "
            f"{n} rows")
    require(fw["first_batch_dtypes"] == {"image": "torch.uint8",
                                         "label": "torch.int64"}
            and fw["first_batch_device"].startswith("cuda"),
            f"framework: first batch {fw['first_batch_dtypes']} on "
            f"{fw['first_batch_device']}")
    require(fw["feed_batches"] == fw["framework_n_images"] // n,
            f"framework: {fw['feed_batches']} batches fed")
    require(all(math.isfinite(x) for x in fw["losses"]),
            f"framework: non-finite ResNet loss: {fw['losses']}")
    require(fw["launches"] == {},
            f"framework: the ResNet loop launched {fw['launches']}")
    counts, steps = fw["gpt2_launches"], fw["gpt2_steps_timed"]
    whole_names = ["whole_attention_forward", "whole_attention_backward",
                   "attention_delta"]
    n_layer = gpt2.GPT2Config.small().n_layer
    for kname in whole_names:
        require(counts.get(kname, 0) == n_layer * steps,
                f"framework: {kname} launched {counts.get(kname, 0)} times "
                f"in {steps} GPT-2 steps of {n_layer} layers")
    require(set(counts) == set(whole_names),
            f"framework: unexpected kernels on the GPT-2 path: {counts}")
    require(fw["gpt2_losses"] == phase6["gpt2_losses"]
            and fw["gpt2_grad_norms"] == phase6["gpt2_grad_norms"],
            f"framework: the worker's GPT-2 steps differ from phase 6's: "
            f"{fw['gpt2_losses']} vs {phase6['gpt2_losses']}")
    out = {"device": name, "nvidia_smi": card, "phase_s": phase_s,
           "img_per_sec_per_chip": fw["img_per_sec_per_chip"],
           "step_time_ms": fw["step_time_ms"],
           "raw_img_per_sec_per_chip": phase11["img_per_sec"],
           "raw_step_time_ms": phase11["step_time_ms"],
           "framework_vs_raw": fw["img_per_sec_per_chip"]
           / phase11["img_per_sec"],
           "gpt2_step_time_ms": fw["gpt2_step_time_ms"],
           "phase6_gpt2_step_time_ms": phase6["gpt2_step_time_ms"],
           "gpt2_bit_equal_phase6": True, "first_batch_equal": True}
    for k in ("init_s", "ingest_s", "ingest_bytes", "fit_s",
              "worker_start_s", "fit_to_first_batch_s",
              "fit_to_first_step_s", "feed_s", "feed_batches",
              "model_init_s", "compile_s", "ms_by_window", "mfu", "losses",
              "max_memory_allocated_bytes", "gpt2_ms_by_window",
              "gpt2_compile_s", "gpt2_launches", "gpt2_steps_timed",
              "gpt2_losses", "gpt2_max_memory_allocated_bytes"):
        if k in fw:
            out[k] = fw[k]
    out["ingest_gb_per_s"] = fw["ingest_bytes"] / fw["ingest_s"] / 1e9
    print("framework", json.dumps(out), flush=True)
    return {"gpt2_launches": counts}


def remote_learner_parity(name, card) -> dict:
    """Phase 24a: one ``LearnerGroup`` learner actor on the card (its
    spec on cuda: granted num_gpus=1) against a local CPU learner from
    the same spec seed, REMOTE_LEARNER_UPDATES updates on fresh 512-row
    PPO batches, each held by hold_update (grads and params, f32, TF32
    off in both processes). Then a PPO WorkerSet with the learner's
    policy on the card and 2 remote CPU rollout workers: after
    ``sync_weights`` of perturbed card weights, the workers' weights
    byte-equal to the learner's host copy."""
    from ray_tpu_torch.rllib import PPOConfig
    from ray_tpu_torch.rllib import core as C
    from ray_tpu_torch.rllib import env as E

    def spec(dev):
        return C.RLModuleSpec(E.Box(-1, 1, (16,)), E.Discrete(6),
                              {"fcnet_hiddens": [256, 256]}, seed=SEED,
                              device=dev)

    conf = {"lr": 5e-4, "grad_clip": 0.5}
    # the WorkerSet's CPU workers start while the learner actor does
    algo = (PPOConfig().environment("CartPole-v1")
            .rollouts(num_workers=2, rollout_fragment_length=32)
            .training(train_batch_size=64, sgd_minibatch_size=64,
                      num_sgd_iter=1)
            .resources(device="cuda").debugging(seed=SEED).build())
    try:
        out = learner_group_updates(spec, conf)
        sync_to_cpu_workers(algo, out)
    finally:
        algo.cleanup()
    print("remote_learner", json.dumps({**out, "device": name,
                                        "nvidia_smi": card}), flush=True)
    return out


def learner_group_updates(spec, conf) -> dict:
    """Phase 24a's learner half (``remote_learner_parity``)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import core as C
    t0 = time.perf_counter()
    group = C.LearnerGroup(C.PPOLearner, num_learners=1,
                           learner_kwargs={"module_spec": spec("cuda"),
                                           "config": conf})
    out = {"learner_start_s": time.perf_counter() - t0}
    try:
        free_gpus = rt.available_resources().get("GPU", 0.0)
        require(free_gpus == 0.0, f"the learner actor holds no GPU: "
                f"{free_gpus} free")
        cpu = C.PPOLearner(module_spec=spec("cpu"), config=conf)
        mid = "default_policy"
        w_card = group.get_state()["module"][mid]
        w_cpu = cpu.get_state()["module"][mid]
        require(all(np.array_equal(w_card[k], w_cpu[k]) for k in w_cpu),
                "the card learner's initial weights are not the CPU's")
        rng = np.random.default_rng(SEED)
        holds = []
        for i in range(REMOTE_LEARNER_UPDATES):
            n = 512
            batch = {
                "obs": rng.standard_normal((n, 16)).astype(np.float32),
                "actions": rng.integers(0, 6, n).astype(np.int32),
                "action_logp": rng.uniform(-2.5, -1.0, n).astype(
                    np.float32),
                "advantages": rng.standard_normal(n).astype(np.float32),
                "value_targets": rng.standard_normal(n).astype(
                    np.float32)}
            g_card = rt.get(group._workers[0].compute_gradients.remote(
                batch))[mid]
            res = group.update_from_batch(batch)
            require(res == {mid: {"workers": 1.0}},
                    f"learner group update {i}: {res}")
            g_cpu = cpu.compute_gradients(batch)
            cpu.apply_gradients(g_cpu)
            g_cpu = g_cpu[mid]
            holds.append(hold_update(
                f"remote_learner_update_{i}",
                ({}, cpu.get_state()["module"][mid],
                 {f"grad.{k}": v for k, v in g_cpu.items()}),
                ({}, group.get_state()["module"][mid],
                 {f"grad.{k}": v for k, v in g_card.items()})))
        out["updates_held"] = len(holds)
        out["worst_gap_of_scale"] = max(h["worst_gap_of_scale"]
                                        for h in holds)
    finally:
        group.shutdown()
    return out


def sync_to_cpu_workers(algo, out):
    """Phase 24a's WorkerSet half (``remote_learner_parity``): perturbed
    card weights, ``sync_weights``, the CPU workers' weights byte-equal
    to the learner's host copy."""
    import torch
    import ray_tpu_torch as rt
    policy = algo.get_policy()
    require(policy.device.type == "cuda",
            f"the learner's policy is on {policy.device}")
    with torch.no_grad():
        gen = torch.Generator(policy.device).manual_seed(SEED)
        for prm in policy.model.parameters():
            prm.add_(0.01 * torch.randn(prm.shape, generator=gen,
                                        device=prm.device))
    algo.workers.sync_weights()
    host = policy.get_weights()
    workers = algo.workers.remote_workers
    held = rt.get([w.get_weights.remote() for w in workers])
    where = rt.get([w.apply.remote(lambda w: str(w.policy.device))
                    for w in workers])
    require(where == ["cpu", "cpu"],
            f"the rollout workers' policies are on {where}")
    require(all(w.keys() == host.keys() and all(
        w[k].dtype == host[k].dtype and np.array_equal(w[k], host[k])
        for k in host) for w in held),
        "after sync_weights a rollout worker's weights differ from the "
        "card learner's host copy")
    out["synced_workers_byte_equal"] = len(held)


def hold_remote_algo(algo, r) -> dict:
    """Phase 24d's checks of one algorithm's keys in
    bench.remote_algo_loops' result: the learner on the card, 2 remote workers, weights that moved, the
    workers holding the learner's weights after a sync, and the steps
    and learner counts each timed iteration must show for the config.
    Returns env steps/s and the counts."""
    pre = algo.lower().replace("-", "_")
    c, cfg = r[f"{pre}_counts"], r[f"{pre}_config"]
    steps = r[f"{pre}_env_steps_per_iter"]
    require(r[f"{pre}_learner_device"].startswith("cuda")
            and r[f"{pre}_num_workers"] == 2
            and r[f"{pre}_weights_moved"] > 0
            and r[f"{pre}_workers_hold_learner_weights"]
            and r[f"{pre}_launches"] == {}, f"{algo}: {r}")
    frag = cfg.get("rollout_fragment_length")
    if algo == "DDPPO":
        ok = (set(steps) == {2 * frag * cfg["num_envs_per_worker"]}
              and set(c["num_ddppo_workers"]) == {2})
    elif algo.startswith("Apex"):
        n, k = c["num_learner_steps"], cfg["train_intensity_per_iter"]
        ok = (n[0] >= k and all(b - a == k for a, b in zip(n, n[1:]))
              and all(0 < x <= 8 * frag for x in steps))
    elif algo == "A3C":
        ok = all(1 <= g <= cfg["max_grads_per_step"] and x == g * frag
                 for g, x in zip(c["num_grads_applied"], steps))
    elif algo in ("ES", "ARS"):
        ok = set(c["episodes_this_iter"]) == {
            2 * 2 * cfg["rollouts_per_worker"]}
    else:
        ok = (set(c["evaluation_episodes"]) == {
            cfg["evaluation_num_episodes"]}
            and set(steps) == {cfg["train_batch_size"]})
    require(ok, f"{algo}: counts {c}, steps {steps}, config {cfg}")
    return {"env_steps_per_sec": r[f"{pre}_env_steps_per_sec"],
            "counts": c}


def rl_remote_phase(name, card, phase15, phase16) -> dict:
    """Phase 24 (module docstring): RLlib's runtime half on this card,
    on one cluster of REMOTE_CPUS CPUs. ``phase15``: bench.ppo_loop's
    result in this process (the one-local-worker form); ``phase16``:
    bench.impala_loop's. Returns the printed measurements."""
    import gc
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch import bench, kernels

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    rt.init(num_cpus=REMOTE_CPUS, object_store_memory=bench.store_bytes())
    try:
        res = rt.cluster_resources()
        require(res.get("GPU") == 1.0 and res.get("CPU") == REMOTE_CPUS,
                f"cluster_resources: {res}")
        # 24a
        learner = remote_learner_parity(name, card)

        # 24b
        def show(tag, r, key):
            profile = r.pop(key, None)
            print(tag, json.dumps({**r, "device": name, "nvidia_smi": card}),
                  flush=True)
            if profile is not None:
                print(tag.replace("_train", "_profile"),
                      json.dumps(profile), flush=True)
            return profile

        p = bench.ppo_remote_loop(profile=lambda learn: profile_step(
            learn, PPO_PROFILE_GROUPS))
        ppo_profile = show("ppo_remote_train", p, "ppo_remote_profile")
        require(p["ppo_remote_obs_shape"] == [84, 84, 4]
                and p["ppo_remote_num_workers"] == 10
                and p["ppo_remote_num_envs_per_worker"] == 5
                and p["ppo_remote_env_steps_per_iter"] == 5000
                and p["ppo_remote_minibatch"] == 500
                and p["ppo_remote_num_sgd_iter"] == 10,
                f"ppo remote widths: {p}")
        require(all(math.isfinite(x) for x in p["ppo_remote_total_losses"]),
                f"ppo remote: non-finite loss {p['ppo_remote_total_losses']}")
        require(p["ppo_remote_weights_moved"] > 0,
                "ppo remote: the weights did not move")
        require(p["ppo_remote_workers_hold_learner_weights"],
                "ppo remote: a worker's weights differ from the learner's "
                "after sync_weights")
        ppo = {
            "remote_env_steps_per_sec": p["ppo_remote_env_steps_per_sec"],
            "local_env_steps_per_sec": phase15["ppo_env_steps_per_sec"],
            "remote_vs_local": p["ppo_remote_env_steps_per_sec"]
            / phase15["ppo_env_steps_per_sec"],
            "remote_timers_ms": {k: p[f"ppo_remote_{k}"] for k in (
                "sample_time_ms", "postprocess_time_ms", "learn_time_ms")},
            "local_timers_ms": {k: phase15[f"ppo_{k}"] for k in (
                "sample_time_ms", "postprocess_time_ms", "learn_time_ms")},
            "remote_sample_share": p["ppo_remote_sample_share"],
            "remote_learn_idle_share": ppo_profile["device_idle_share"],
            "actor_start_s_max": max(p["ppo_remote_actor_start_s"])}
        print("ppo_remote_vs_local", json.dumps({
            **ppo, "device": name, "nvidia_smi": card}), flush=True)

        # 24c
        i = bench.impala_remote_loop()
        show("impala_remote_train", i, "impala_remote_profile")
        require(i["impala_remote_obs_shape"] == [84, 84, 4]
                and i["impala_remote_num_envs_per_worker"] == 5
                and i["impala_remote_num_workers"] == min(
                    bench.IMPALA_YAML_WORKERS,
                    max(1, bench.usable_cpus() - 2)),
                f"impala remote widths: {i}")
        require(all(math.isfinite(x)
                    for x in i["impala_remote_total_losses"]),
                "impala remote: non-finite loss "
                f"{i['impala_remote_total_losses']}")
        require(i["impala_remote_weights_moved"] > 0
                and i["impala_remote_learner_steps"] > 0
                and i["impala_remote_learner_rows_trained"] > 0,
                f"impala remote: the learner thread did not learn: {i}")
        impala = {
            "remote_env_steps_per_sec": i["impala_remote_env_steps_per_sec"],
            "local_env_steps_per_sec": phase16["impala_env_steps_per_sec"],
            "remote_vs_local": i["impala_remote_env_steps_per_sec"]
            / phase16["impala_env_steps_per_sec"],
            "workers_cut": i["impala_remote_workers_cut"],
            "learner_queue_size_by_iter":
                i["impala_remote_learner_queue_size_by_iter"],
            "learner_queue_wait_s": i["impala_remote_learner_queue_wait_s"],
            "learner_time_s": i["impala_remote_learner_time_s"],
            "window_s": i["impala_remote_window_s"]}
        print("impala_remote_vs_local", json.dumps({
            **impala, "device": name, "nvidia_smi": card}), flush=True)

        # 24d
        small = {}
        loops = bench.remote_algo_loops()
        for algo in bench.REMOTE_ALGOS:
            pre = algo.lower().replace("-", "_")
            r = {k: v for k, v in loops.items() if k.startswith(pre + "_")}
            show(f"{pre}_train", r, None)
            small[algo] = hold_remote_algo(algo, r)
    finally:
        rt.shutdown()
    # 24e
    launches = kernels.launch_counts()
    require(launches == {}, f"phase 24 launched {launches}")
    out = {"phase_s": time.perf_counter() - t_phase, "learner": learner,
           "ppo": ppo, "impala": impala, "small": small,
           "launches": launches}
    print("rl_remote", json.dumps({**out, "device": name,
                                   "nvidia_smi": card}), flush=True)
    return out


def serve_streams(server, prompts, new_tokens: int):
    """One greedy stream of ``new_tokens`` per prompt, opened together
    on ``server`` and drained in turn, with the launch counts and the
    adapter's decode steps zeroed just before: (results [(tokens, last
    chunk)], wall seconds, the paged-decode kernel's launches, decode
    steps). Fails unless every stream ends with ``new_tokens`` tokens
    in the vocab and finish_reason "length"."""
    from ray_tpu_torch import kernels
    kernels.reset_launch_counts()
    server.adapter.decode_steps = 0
    t0 = time.time()
    sids = [server.__llm_open__({"tokens": p, "max_new_tokens": new_tokens})
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
    vocab = server.adapter.vocab_size
    for toks, chunk in results:
        require(not chunk.get("error"), f"stream failed: {chunk}")
        require(len(toks) == new_tokens and chunk["finish_reason"] == "length",
                f"stream ended with {len(toks)} tokens: {chunk}")
        require(all(0 <= t < vocab for t in toks), "token range")
    return results, wall, launches, steps


class _Seq:
    """What the adapter reads of an engine sequence."""

    def __init__(self, seq_id, prompt):
        self.seq_id, self.prompt, self.tokens = seq_id, prompt, []


def llama_serve(name, card) -> dict:
    """Phase 5b: Llama-2-7B at its published widths and depth (random
    weights from SEED, bf16 compute, the f32 head) behind LLMServer on
    the card: a warm-up request, then 16 concurrent streams of 64 greedy
    tokens from seeded prompts of 64-768 tokens. The paged-decode kernel
    must take every layer of every decode step. Then, outside the
    engine, the same prompts prefilled as one batch and decode steps of
    all 16 rows: their host time and one profiled step by
    SERVE_PROFILE_GROUPS. Returns the printed measurements."""
    import gc
    import torch
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import LLMServer
    cfg = llama.LlamaConfig.llama2_7b()
    rng = np.random.RandomState(SEED + 2)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    server = LLMServer(
        model="llama", model_config={"config": cfg, "seed": SEED},
        engine_config={"max_running": 16, "max_seq_len": 2048,
                       "block_size": 16, "num_blocks": 1025})
    init_s = time.time() - t0
    adapter = server.adapter
    require(server.engine.config.max_seq_len == 2048
            and adapter.nb_max == 128, "llama serve: max_seq_len or table")
    weights = {str(p.dtype): 0 for p in adapter.model.parameters()}
    for p in adapter.model.parameters():
        weights[str(p.dtype)] += p.numel() * p.element_size()
    try:
        warm = server({"tokens": [1, 450, 4996], "max_new_tokens": 4})
        require(warm["n_tokens"] == 4, f"llama warm-up request: {warm}")
        prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
                   for n in rng.randint(64, 769, size=16)]
        results, wall, launches, steps = serve_streams(server, prompts, 64)
        m = server.engine.metrics()
    finally:
        server.engine.stop()
    peak = torch.cuda.max_memory_allocated()
    require(steps > 0 and launches == cfg.n_layers * steps,
            f"llama serve: paged_attention_decode launched {launches} times "
            f"over {steps} decode steps of {cfg.n_layers} layers")
    # where a decode step's time goes, outside the engine (informational;
    # after the counts were read): the same 16 prompts prefilled as one
    # batch, then decode steps of all 16 rows, timed on the host clock
    # (adapter.decode returns host logits: synchronised) and one profiled
    seqs = [_Seq(f"p{i}", p) for i, p in enumerate(prompts)]
    for sq in seqs:
        adapter.cache.allocate(sq.seq_id, len(sq.prompt) + 8)
        sq.tokens = [0]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    adapter.prefill(seqs)
    prefill_s = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated()
    adapter.decode(seqs)
    step_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        adapter.decode(seqs)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    profile = profile_step(lambda: adapter.decode(seqs),
                           SERVE_PROFILE_GROUPS)
    ttft = sorted(c["ttft_s"] for _, c in results)
    res = {"model": "llama-2-7b", "n_layers": cfg.n_layers, "dim": cfg.dim,
           "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
           "streams": 16, "new_tokens": 64,
           "prompt_tokens": [len(p) for p in prompts],
           "wall_s": wall, "tokens_per_s": 16 * 64 / wall,
           "ttft_p50_s": ttft[len(ttft) // 2], "ttft_p99_s": ttft[-1],
           "itl_p50_s": m["itl_p50_s"], "itl_p99_s": m["itl_p99_s"],
           "decode_steps": steps, "kernel_launches": launches,
           "weight_bytes_by_dtype": weights,
           "kv_pool_bytes": 2 * adapter.k_pages.numel()
           * adapter.k_pages.element_size(),
           "init_s": init_s, "max_memory_allocated_bytes": peak,
           "prefill_16_rows_s": prefill_s,
           "prefill_16_rows_max_memory_allocated_bytes": prefill_peak,
           "decode_step_ms_16_rows": step_ms,
           "device": name, "nvidia_smi": card}
    print("llama_serve", json.dumps(res), flush=True)
    print("llama_serve_profile", json.dumps(profile), flush=True)
    del server, adapter, results
    gc.collect()
    torch.cuda.empty_cache()
    return res


def llama_serve_numerics(n_kv_heads: int):
    """Phase 5c: Llama-2-7B's widths at 2 layers with ``n_kv_heads``
    kv heads, f32, TF32 off (phase 1), on the card. 8 ragged prompts of
    37-700 tokens go through the adapter's paged prefill (one padded
    batch), then one batched decode step through ``adapter.decode`` (the
    kernel: one launch a layer) is held within 1e-3 (phase 5's
    tolerance) of the same step with the plain version passed
    explicitly and of the full forward at the same positions. Then
    speculative decoding with this model as the target: 4 prompts x 16
    greedy tokens with ``make_draft("llama")`` of the same config and
    seed (the target itself: every proposal accepted) and of another
    seed (proposals rejected) must be token-identical to spec_k = 0."""
    import gc
    import torch
    from ray_tpu_torch import kernels
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.serve.llm import (LLMServer, PagedKVCache,
                                         TorchModelAdapter)
    cfg = dataclasses.replace(
        llama.LlamaConfig.llama2_7b(), n_layers=2, n_kv_heads=n_kv_heads,
        dtype=torch.float32, attention_backend="reference")
    rng = np.random.RandomState(SEED + 3)
    B, bs = 8, 16
    adapter = TorchModelAdapter("llama", config=cfg, seed=SEED)  # cuda
    adapter.bind_cache(PagedKVCache(
        num_blocks=1 + B * cfg.max_seq_len // bs, block_size=bs))
    n_prompt = ragged(rng, B, 37, 700)
    ids = rng.randint(0, cfg.vocab_size, size=(B, max(n_prompt) + 1))
    seqs = [_Seq(f"s{b}", ids[b, :n].tolist())
            for b, n in enumerate(n_prompt)]
    for sq in seqs:
        adapter.cache.allocate(sq.seq_id, len(sq.prompt) + 1)
    tables = np.zeros((B, adapter.nb_max), np.int32)
    for b, sq in enumerate(seqs):
        t = adapter.cache.block_table(sq.seq_id)
        tables[b, :len(t)] = t
    adapter.prefill(seqs)
    for b, sq in enumerate(seqs):
        sq.tokens = [int(ids[b, n_prompt[b]])]
    kernels.reset_launch_counts()
    via_kernel = adapter.decode(seqs)                       # [B, V] f32
    require(kernels.launch_counts().get("paged_attention_decode")
            == cfg.n_layers, f"llama f32 decode step (Hkv {n_kv_heads}) "
            "missed the kernel")
    dev = adapter.device
    tab = torch.as_tensor(tables, device=dev)
    caches = [{"k_pages": adapter.k_pages[l], "v_pages": adapter.v_pages[l],
               "block_tables": tab} for l in range(cfg.n_layers)]
    with torch.no_grad():
        # the same step again (it rewrites the same K/V in the same
        # slots) with the plain version of the kernel
        h = adapter.model.trunk(
            torch.as_tensor(ids[np.arange(B), n_prompt][:, None], device=dev),
            kv_cache=caches,
            seq_lengths=torch.as_tensor(n_prompt, dtype=torch.int32,
                                        device=dev),
            paged_decode=A.paged_attention_reference)
        via_plain = adapter.model.head(h[:, 0]).cpu().numpy()
        err_full = 0.0
        for b, n in enumerate(n_prompt):
            full = adapter.model(torch.as_tensor(ids[b:b + 1, :n + 1],
                                                 device=dev))
            err_full = max(err_full, float(np.abs(
                via_kernel[b] - full[0, -1].cpu().numpy()).max()))
    err_plain = float(np.abs(via_kernel - via_plain).max())
    require(np.isfinite(via_kernel).all()
            and via_kernel.shape == (B, cfg.vocab_size),
            f"llama decode logits {via_kernel.shape} not finite")
    require(err_plain <= 1e-3, f"llama kernel vs plain decode step "
            f"(Hkv {n_kv_heads}): {err_plain}")
    require(err_full <= 1e-3, f"llama decode step vs full forward "
            f"(Hkv {n_kv_heads}): {err_full}")
    del adapter, caches
    gc.collect()
    torch.cuda.empty_cache()

    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in ragged(rng, 4, 8, 200)]
    spec = {}
    for label, spec_k, draft_seed in (("plain", 0, None), ("self", 4, SEED),
                                      ("other", 4, SEED + 1)):
        engine = {"max_running": 4, "max_seq_len": 2048, "block_size": bs,
                  "num_blocks": 1 + 4 * 16, "spec_k": spec_k}
        if spec_k:
            engine.update(draft_model="llama", draft_model_config={
                "config": cfg, "seed": draft_seed})
        server = LLMServer(model="llama",
                           model_config={"config": cfg, "seed": SEED},
                           engine_config=engine)
        try:
            results, _, _, _ = serve_streams(server, prompts, 16)
            m = server.engine.metrics()
        finally:
            server.engine.stop()
        spec[label] = {"tokens": [t for t, _ in results],
                       "drafted": m["spec_draft_tokens_total"],
                       "accepted": m["spec_accepted_tokens_total"]}
        del server
        gc.collect()
        torch.cuda.empty_cache()
    for label in ("self", "other"):
        require(spec[label]["tokens"] == spec["plain"]["tokens"],
                f"llama spec decode ({label} draft, Hkv {n_kv_heads}): "
                "tokens differ from plain greedy")
        require(spec[label]["drafted"] > 0,
                f"llama spec decode ({label} draft): nothing drafted")
    require(spec["self"]["accepted"] == spec["self"]["drafted"],
            f"llama spec decode: the target's own weights as the draft had "
            f"{spec['self']['drafted'] - spec['self']['accepted']} proposals "
            "rejected")
    print("llama_serve_numerics", json.dumps({
        "dtype": "float32", "n_layers": cfg.n_layers,
        "kv_heads": n_kv_heads, "batch": B, "prompt_tokens": n_prompt,
        "max_abs_err_vs_plain": err_plain,
        "max_abs_err_vs_full_forward": err_full, "tol": 1e-3,
        "spec": {k: {"drafted": v["drafted"], "accepted": v["accepted"]}
                 for k, v in spec.items()},
        "spec_token_identical": True}), flush=True)


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
    # attention kernels' tensor-core bodies
    print("kernel_resources", json.dumps(
        [r for src in ("whole_attention", "flash_attention")
         for r in A.attention_resource_usage(src)
         if not r["kernel"].endswith("_kernel")]
        + kernels.resource_usage("attention_delta")
        + A.paged_resource_usage()), flush=True)

    # 3. kernel against its plain version
    # a 1 GB write evicts the 50 MB L2 and lasts ~0.3 ms, longer than a
    # wrapper's host work, so no timed window waits on a launch
    scratch = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_
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
    # one long sequence beside a short one, where the split matters most
    paged_case("d: long, small batch", 2, 32, 8, 128, 16, 256, [4096, 1],
               "bfloat16", 2e-2, flush)
    # lengths on and one past the kernel's split boundaries, a length-0
    # row (batch padding) and a full table
    span = A.paged_split_plan(8, 12, 64, 16, 64, 4).split_pages * 16
    paged_case("e: split edges", 8, 12, 12, 64, 16, 64,
               [0, 1, span - 1, span, span + 1, 2 * span, 2 * span + 1,
                64 * 16], "float32", 1e-4, flush)
    # Llama-2-7B serving's shape (phase 5b): G = 1 at D 128 over a full
    # 128-page table, lengths across all of it (its own generator: the
    # phases after it draw what they drew before)
    llama_case = paged_case(
        "f: llama-2-7b serve shape", 16, 32, 32, 128, 16, 128,
        ragged(np.random.RandomState(SEED + 1), 16, 1, 2048), "bfloat16",
        2e-2, flush)
    print("kernel_resources_llama_serve", json.dumps(
        [r for r in A.paged_resource_usage(128, 16, 128, 2)
         if r["dtype"] == "bfloat16" and (r["d"], r.get("g")) in
         ((128, 1), (None, None))]), flush=True)
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
                  "bfloat16", True),
                 # the wgmma backward's edges (d 64, 128; 128-row CTA
                 # tiles): lengths that are not a multiple of 128, not
                 # causal, past the cap at d 128
                 ("f: s 192, d 128", 2, 3, 192, 128, "bfloat16", True),
                 ("f: s 320, d 64", 2, 3, 320, 64, "bfloat16", True),
                 ("f: not causal, d 64", 2, 3, 256, 64, "bfloat16", False),
                 ("d: logits past the cap, d 128", 2, 2, 256, 128,
                  "bfloat16", True, 8.0)):
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
    del scratch, flush

    # 4. serve GPT-2 small through the port's entry points
    cfg = gpt2.GPT2Config.small()
    server = phase4_server()
    try:
        warm = server({"tokens": [464, 3290, 318], "max_new_tokens": 4})
        require(warm["n_tokens"] == 4, f"warm-up request: {warm}")
        prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
                   for n in rng.randint(64, 769, size=16)]
        results, wall, launches, steps = serve_streams(server, prompts, 64)
        engine_m = server.engine.metrics()
        alone = serve_alone(server, prompts, 64)
    finally:
        server.engine.stop()
    ttft = sorted(c["ttft_s"] for _, c in results)
    phase4 = {"prompts": prompts, "tokens": [t for t, _ in results],
              "alone_tokens": alone["tokens"],
              "tokens_per_s": 16 * 64 / wall,
              "ttft_p50_s": ttft[len(ttft) // 2], "ttft_p99_s": ttft[-1],
              "engine_itl_p50_s": engine_m["itl_p50_s"],
              "engine_itl_p99_s": engine_m["itl_p99_s"]}
    require(steps > 0 and launches == cfg.n_layer * steps,
            f"paged_attention_decode launched {launches} times over "
            f"{steps} decode steps of {cfg.n_layer} layers")
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

    # 5b. serve Llama-2-7B at full width and depth; 5c. its decode step
    # and speculative decoding in f32, at 32 and at 8 kv heads
    llama_serve_res = llama_serve(name, card)
    for n_kv_heads in (32, 8):
        llama_serve_numerics(n_kv_heads)

    # 6. train GPT-2 small through the port's trainer: the bench's
    # gpt2_loop (launch counts zeroed after its warm-up, read after its
    # timed windows), then one profiled step
    from ray_tpu_torch import bench
    cfg = gpt2.GPT2Config.small()
    g = bench.gpt2_loop(profile=profile_step)
    losses, norms = g["gpt2_losses"], g["gpt2_grad_norms"]
    train_counts, n_steps = g["gpt2_launches"], g["gpt2_steps_timed"]
    require(all(math.isfinite(x) for x in losses + norms),
            f"non-finite loss or grad norm: {losses} {norms}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    whole_names = ["whole_attention_forward", "whole_attention_backward",
                   "attention_delta"]
    for kname in whole_names:
        require(train_counts.get(kname, 0) == cfg.n_layer * n_steps,
                f"{kname} launched {train_counts.get(kname, 0)} times in "
                f"{n_steps} steps of {cfg.n_layer} layers")
    require(set(train_counts) == set(whole_names),
            f"unexpected kernels on the training path: {train_counts}")
    profile = g.pop("gpt2_profile")
    print("train", json.dumps({"model": "gpt2-small", **g, "device": name,
                               "nvidia_smi": card}), flush=True)
    print("train_profile", json.dumps(profile), flush=True)
    torch.cuda.empty_cache()

    # 7. one training step through the kernels against one through
    # their plain versions, in f32 and in bf16 compute
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (4, 1024), dtype=np.int32)
    train_parity(dataclasses.replace(cfg, n_layer=2), tokens)
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
    for kname in streaming_names + ["attention_delta"]:
        require(llama_counts.get(kname, 0) == lcfg.n_layers * n_steps,
                f"{kname} launched {llama_counts.get(kname, 0)} times in "
                f"{n_steps} steps of {lcfg.n_layers} layers")
    require(set(llama_counts) == set(streaming_names + ["attention_delta"]),
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

    # 11. ResNet: (a) the narrow step on the card against the CPU; (b)
    # ResNet-50 at 256 x 224 x 224 bf16 through the bench's
    # resnet_loop, which launches none of the port's kernels; (c) one
    # profiled step, by kernel group
    resnet_parity()
    r = bench.resnet_loop(profile=lambda step: profile_step(
        step, RESNET_PROFILE_GROUPS))
    require(all(math.isfinite(x) for x in r["losses"]),
            f"resnet: non-finite loss: {r['losses']}")
    require(r["launches"] == {}, f"resnet: the path launched {r['launches']}")
    profile = r.pop("profile")
    print("resnet_train", json.dumps({"model": "resnet50", **r,
                                      "device": name, "nvidia_smi": card}),
          flush=True)
    print("resnet_profile", json.dumps(profile), flush=True)
    phase11 = {k: r[k] for k in ("step_time_ms", "img_per_sec")}
    del r
    torch.cuda.empty_cache()

    # 12. mesh: the same trainers on a NCCL process group of one rank
    mesh_counts = mesh_phase(cfg, tokens, g, phase11, name, card)
    torch.cuda.empty_cache()

    # 14. parallel: the ring's schedule at full width, the ring and the
    # pipeline through their trainers on a NCCL group of one rank, MoE
    ring = ring_phase(4, 4096, name, card)
    with one_rank_group():
        ring_train_counts = ring_trainer_phase(g, name, card)
        pipe_counts = pipelined_phase(g, name, card)
    moe_phase()
    torch.cuda.empty_cache()

    # 15. RLlib's local PPO path at the Atari widths: none of the port's
    # kernels
    phase15 = ppo_phase(name, card)

    # 16. IMPALA/APPO, the learner thread and DQN at the Atari widths:
    # none of the port's kernels
    phase16 = rl_algos_phase(name, card)["impala"]

    # 17. SAC and TD3 on Pendulum, CQL, CRR, MARWIL and BC offline: none
    # of the port's kernels
    offpolicy_phase(name, card)

    # 18. LocalAlgorithm: R2D2, SlateQ, DT and the bandits: none of the
    # port's kernels
    local_algos_phase(name, card)

    # 19. QMIX and MADDPG, MAML and MBMPO: none of the port's kernels
    multiagent_meta_phase(name, card)

    # 20. Dreamer, AlphaZero, AlphaStar and multi-agent PPO: none of the
    # port's kernels
    model_based_phase(name, card)

    # 21. (a) checkpoints of GPT-2 small's trainer: save, restore,
    # resume; (b) prefill/decode disaggregation of phase 4's streams
    ckpt = checkpoint_phase(name, card)
    disagg = disagg_phase(name, card, phase4)

    # 22. the runtime: GPT-2 small trained and served inside GPU-granted
    # actors, a CPU task that sees no GPU, the host's numbers
    runtime = runtime_phase(name, card, phase4["prompts"])

    # 23. the headline bench's framework path: ResNet-50 and GPT-2 small
    # in a GPU-granted train worker that DataParallelTrainer.fit()
    # started, fed by the Dataset through iter_device_batches
    framework = framework_phase(name, card, g, phase11)

    # 24. RLlib's runtime half: a learner actor on the card, PPO-Atari at
    # 10 remote workers x 5 envs, IMPALA's async learner fed by remote
    # workers, DDPPO, Ape-X DQN/DDPG, A3C, ES, ARS and evaluation workers:
    # none of the port's kernels
    rl_remote_phase(name, card, phase15, phase16)

    # 25. serve on the runtime: the LLM server as a GPU-granted replica
    # behind the controller, the router and the HTTP proxy (SSE)
    serve_rt = serve_runtime_phase(name, card, phase4)

    # 13. summary
    def kernel_entry(case, kname, source, line, by_path):
        """``by_path``: {path: launches of ``kname`` in its counted
        run}; ``launches`` is their sum."""
        return {"name": kname, "route": "cuda",
                "source": f"ray_tpu_torch/kernels/csrc/{source}",
                "replaces": f"ray_tpu/ops/attention.py:{line}",
                "launches": sum(by_path.values()),
                "launches_by_path": by_path, "case": case.get("case"),
                "max_abs_err": case["max_abs_err"], "ms": case["ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"],
                "library_ms": case["library_ms"],
                "library_covers": case.get("library_covers", [])}

    def by_path(kname, *paths):
        return {path: counts[kname] for path, counts in paths
                if kname in counts}

    gpt2_paths = (("gpt2_train", train_counts),
                  ("mesh_gpt2_train", mesh_counts["gpt2_train"]),
                  ("pipelined_train", pipe_counts),
                  ("checkpoint_train", ckpt["checkpoint"]["launches"]),
                  ("runtime_actor_train", runtime["train_launches"]),
                  ("framework_gpt2_train", framework["gpt2_launches"]))
    streaming_paths = (("llama_train", llama_counts),
                       ("mesh_gpt2_exact", mesh_counts["gpt2_exact"]),
                       ("ring_schedule", ring["launches"]),
                       ("ring_train", ring_train_counts))
    ring_case = {k: ring[k] for k in ("shape", "sp", "rank_ms", "whole_ms",
                                      "last_rank_over_quarter")}
    main_whole = whole["a: train shape", "bfloat16"]
    main_flash = flash["a: llama train shape", "bfloat16"]
    summary = {"kernels": [
        {**kernel_entry({**main_case, "library_ms": None},
                        "paged_attention_decode", "paged_decode.cu", 803,
                        {"serve": launches,
                         "llama_serve": llama_serve_res["kernel_launches"],
                         "disagg_decode":
                             disagg["disagg_paged_decode_launches"],
                         "runtime_actor_serve": runtime["serve_launches"],
                         "serve_runtime_replica":
                             serve_rt["serve_paged_decode_launches"]}),
         "llama_serve_case": {k: llama_case[k] for k in (
             "case", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by")}},
        *(kernel_entry(main_whole[kname], kname, "whole_attention.cu", line,
                       by_path(kname, *gpt2_paths))
          for kname, line in (("whole_attention_forward", 86),
                              ("whole_attention_backward", 110))),
        *({**kernel_entry(main_flash[kname], kname, "flash_attention.cu",
                          line, by_path(kname, *streaming_paths)),
           "ring_case": ring_case}
          for kname, line in zip(streaming_names, (303, 410, 469))),
        # the delta pass of both backwards: in the JAX package a jnp.sum
        # in _whole_backward (:262) and _flash_backward (:528) that XLA
        # compiles, no Pallas kernel; held and timed at GPT-2's shape,
        # launched by both training paths
        {**kernel_entry(main_whole["attention_delta"], "attention_delta",
                        "attention_delta.cu", 262,
                        by_path("attention_delta", *gpt2_paths,
                                *streaming_paths)),
         "replaces_note": "jnp.sum in _whole_backward (:262) and "
                          "_flash_backward (:528): XLA, no Pallas kernel"}]}
    print(card)                  # nvidia-smi's name, power.limit line
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
