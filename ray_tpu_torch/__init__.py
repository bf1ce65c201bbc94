"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu, slice by slice.

Beside the JAX package (``ray_tpu``, the reference), this package runs
the same system with PyTorch on an NVIDIA H100, with every TPU kernel
on a ported path rewritten by hand for Hopper (``kernels/csrc``). It
imports nothing of ``ray_tpu`` and nothing of JAX.

Ported so far:

  - LLM serving of GPT-2 and Llama-2-7B (``serve.llm``), with
    single-token decode attention in a CUDA kernel, speculative decoding
    with model drafts and the local HF imports;
  - GPT-2 training (``train.spmd.make_causal_lm_trainer``) through the
    whole-kv attention kernels (the streaming ones with ``exact=True``);
  - Llama training at 4,096 tokens (``models.llama``) through the
    streaming attention kernels;
  - ResNet image-classifier training (``models.resnet``,
    ``train.spmd.make_image_classifier_trainer``; cuDNN convolutions)
    and its throughput bench (``python -m ray_tpu_torch.bench``);
  - the mesh (``parallel.mesh``, ``parallel.collectives``): both
    trainers on dp x fsdp x tp over a process group (NCCL on the card,
    gloo on the CPU), and the multi-rank dry run
    (``parallel.dryrun``);
  - sequence, pipeline and expert parallelism: ring attention over sp
    (``ops.ring_attention``), the pipelined LM trainer over pp
    (``parallel.pipeline``), the MoE layer over ep (``parallel.moe``);
  - RLlib's local path (``rllib``): PPO through ``Algorithm`` and its
    local rollout worker, and the RLModule / Learner stack, with the
    policy on the card and the envs, connectors and GAE on the host;
    ``bench.ppo_loop`` runs it at the Atari widths.

ROADMAP.md lists the slices to come.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
