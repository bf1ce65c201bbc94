"""The port's RL algorithms: PPO so far (ROADMAP.md Queue A lists the
rest of ``ray_tpu/rllib/algorithms/``)."""

from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig, PPOPolicy

__all__ = ["PPO", "PPOConfig", "PPOPolicy"]
