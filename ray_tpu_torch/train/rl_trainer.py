"""RLTrainer — run an RLlib algorithm through the Train API.

Reference analogue: python/ray/train/rl/rl_trainer.py (+ rl_predictor):
the trainer builds the Algorithm inside a framework-managed worker,
steps it for ``num_iterations``, reports each iteration's metrics
through the session, and checkpoints the algorithm state so
``RLTrainer.get_policy`` can rebuild a serving policy from the AIR
Checkpoint.

The port's copy of ``ray_tpu/train/rl_trainer.py`` over
``ray_tpu_torch.rllib.algorithms``, with the same checkpoint keys
(``rllib_state.pkl``, ``algorithm``, ``config``). The algorithm lives on
``config["device"]`` (``"cuda"`` unless the config asks for ``"cpu"``), so
on the card the trainer needs ``ScalingConfig(use_gpu=True)``: its train
worker is then granted a GPU.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Optional, Type, Union

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.data_parallel_trainer import (BaseTrainer,
                                                 DataParallelTrainer, Result)

ALGO_KEY = "rllib_state.pkl"


class RLTrainer(BaseTrainer):
    """Train an RLlib algorithm as a Train workload."""

    _framework = "rl"

    def __init__(self, *, algorithm: Union[str, Type] = "PPO",
                 config: Optional[Dict[str, Any]] = None,
                 num_iterations: int = 3,
                 stop_reward: Optional[float] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint=None):
        super().__init__(scaling_config=scaling_config,
                         run_config=run_config, datasets=datasets,
                         resume_from_checkpoint=resume_from_checkpoint)
        self.algorithm = algorithm
        self.algo_config = dict(config or {})
        self.num_iterations = num_iterations
        self.stop_reward = stop_reward

    def _with_config_overrides(self, config: Dict[str, Any]):
        merged = {**self.algo_config, **(config or {})}
        return type(self)(
            algorithm=self.algorithm, config=merged,
            num_iterations=self.num_iterations,
            stop_reward=self.stop_reward,
            scaling_config=self.scaling_config, run_config=self.run_config,
            datasets=self.datasets,
            resume_from_checkpoint=self.resume_from_checkpoint)

    @staticmethod
    def _algo_cls(algorithm):
        if not isinstance(algorithm, str):
            return algorithm
        from ray_tpu_torch.rllib import algorithms
        cls = getattr(algorithms, algorithm, None)
        if cls is None:
            raise ValueError(f"unknown RLlib algorithm {algorithm!r}")
        return cls

    def fit(self) -> Result:
        return self._fit_internal(report_through_session=False)

    def _fit_internal(self, report_through_session: bool) -> Result:
        trainer = self

        def train_loop(config):
            from ray_tpu_torch.air import session
            cls = RLTrainer._algo_cls(trainer.algorithm)
            algo = cls(config=dict(config or {}))
            try:
                last = {}
                for it in range(trainer.num_iterations):
                    last = algo.train()
                    reward = last.get("episode_reward_mean")
                    metrics = {
                        "training_iteration": it + 1,
                        "episode_reward_mean": reward,
                        "episodes_total": last.get("episodes_total"),
                    }
                    done = (trainer.stop_reward is not None
                            and reward is not None
                            and reward >= trainer.stop_reward)
                    if it == trainer.num_iterations - 1 or done:
                        state = algo.save_checkpoint()
                        algo_name = (trainer.algorithm
                                     if isinstance(trainer.algorithm, str)
                                     else trainer.algorithm.__name__)
                        ckpt = Checkpoint.from_dict(
                            {ALGO_KEY: pickle.dumps(state),
                             "algorithm": algo_name,
                             "config": dict(config or {})})
                        session.report(metrics, checkpoint=ckpt)
                        if done:
                            break
                    else:
                        session.report(metrics)
            finally:
                algo.cleanup()

        inner = DataParallelTrainer(
            train_loop, train_loop_config=dict(self.algo_config),
            scaling_config=self.scaling_config, run_config=self.run_config,
            datasets=self.datasets,
            resume_from_checkpoint=self.resume_from_checkpoint)
        return inner._fit_internal(report_through_session)

    @staticmethod
    def restore_algorithm(checkpoint: Checkpoint):
        """Rebuild the trained Algorithm from an AIR checkpoint."""
        d = checkpoint.to_dict()
        cls = RLTrainer._algo_cls(d["algorithm"])
        algo = cls(config=dict(d.get("config") or {}))
        algo.load_checkpoint(pickle.loads(d[ALGO_KEY]))
        return algo
