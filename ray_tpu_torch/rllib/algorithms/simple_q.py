"""SimpleQ — deep Q-learning without the DQN extras.

Reference analogue: rllib/algorithms/simple_q/ (simple_q.py,
simple_q_torch_policy.py): plain TD(0) target from a periodically
synced target network — no double-Q, no prioritized replay, no
n-step returns. Counterpart of ``ray_tpu/rllib/algorithms/simple_q.py``:
all machinery is shared with DQN (dqn.py); this config pins the extras
off (the featureful class is the base and SimpleQ is the subtraction).
"""

from __future__ import annotations

from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig


class SimpleQConfig(DQNConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or SimpleQ)
        self._config.update({
            "double_q": False,
            "prioritized_replay": False,
            "lr": 5e-4,
            "train_batch_size": 32,
            "target_network_update_freq": 500,
        })


class SimpleQ(DQN):
    _default_config_cls = SimpleQConfig
