"""ray_tpu_torch.rllib — reinforcement learning on PyTorch.

Counterpart of ``ray_tpu/rllib`` (reference analogue: rllib/ —
Algorithm, RolloutWorker/WorkerSet, SampleBatch, policies): the old
stack (``Algorithm`` -> the WorkerSet's local ``RolloutWorker`` -> a
``TorchPolicy`` or a standalone policy: PPO, IMPALA/APPO, DQN/SimpleQ
with the replay buffers, PG/A2C, SAC, DDPG/TD3; offline from JSON
datasets: BC/MARWIL, CQL, CRR; the bandits; and ``LocalAlgorithm``'s
own env loops: R2D2, SlateQ, DT, the cooperative multi-agent QMIX and
MADDPG, the meta-learners MAML and MBMPO, the model-based and planning
Dreamer, AlphaZero and AlphaStar; the multi-agent worker, which PPO
trains policy by policy) and the new one (``RLModule`` / ``PPOLearner``
/ a ``LearnerGroup``). The
learner's forward, the loss, the backward and Adam run on
``config["device"]`` ("cuda" unless the caller asks for "cpu"); env
stepping, connectors and GAE stay numpy on the host, as in the JAX
package. On the port's runtime (``ray_tpu_torch.init``): remote rollout
and evaluation workers (``num_workers``, ``evaluation_num_workers``;
actors on the CPU), remote learners (``LearnerGroup(num_learners=n)``,
one GPU each on ``cuda``), IMPALA/APPO's async learner, A3C, DDPPO,
Ape-X DQN/DDPG with a replay actor, and ES/ARS.
"""

from ray_tpu_torch.rllib.sample_batch import (MultiAgentBatch, SampleBatch,
                                              convert_ma_batch_to_sample_batch)
from ray_tpu_torch.rllib.env import (Box, CartPoleEnv, Discrete,
                                     MultiAgentCartPole, MultiAgentEnv,
                                     PendulumEnv, PixelCatcher, VectorEnv,
                                     make_env)
from ray_tpu_torch.rllib.connectors import (ClipActionConnector, Connector,
                                            ConnectorPipeline,
                                            FlattenObsConnector,
                                            FrameStackConnector,
                                            GrayscaleObsConnector,
                                            LambdaConnector,
                                            MeanStdObsConnector,
                                            ResizeObsConnector)
from ray_tpu_torch.rllib.models import (AtariCNN, MLPNet, StackedMLP,
                                        make_model, params_from_flax,
                                        policy_map_from_flax,
                                        stacked_params_from_flax)
from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.core import (Learner, LearnerGroup, MultiRLModule,
                                      PPOLearner, RLModule, RLModuleSpec)
from ray_tpu_torch.rllib.postprocessing import compute_advantages
from ray_tpu_torch.rllib.replay_buffers import (PrioritizedReplayBuffer,
                                                ReplayBuffer)
from ray_tpu_torch.rllib.rollout_worker import (MultiAgentRolloutWorker,
                                                RolloutWorker, WorkerSet,
                                                synchronous_parallel_sample)
from ray_tpu_torch.rllib.algorithm import (Algorithm, AlgorithmConfig,
                                           LocalAlgorithm)
from ray_tpu_torch.rllib.offline import JsonReader, JsonWriter
from ray_tpu_torch.rllib.algorithms import (A3C, ARS, BC, CQL, CRR, DDPG,
                                            DDPPO, DQN, DT, ES, MARWIL, PPO,
                                            R2D2, SAC, TD3, A3CConfig,
                                            ApexDDPG, ApexDDPGConfig,
                                            ApexDQN, ApexDQNConfig,
                                            ARSConfig, DDPPOConfig, ESConfig,
                                            AlphaStar, AlphaStarConfig,
                                            AlphaZero, AlphaZeroConfig,
                                            Dreamer, DreamerConfig,
                                            BanditLinTS, BanditLinTSConfig,
                                            BanditLinUCB, BanditLinUCBConfig,
                                            BCConfig, CQLConfig, CRRConfig,
                                            DDPGConfig, DQNConfig, DTConfig,
                                            IMPALA, IMPALAConfig, MADDPG,
                                            MADDPGConfig, MAML, MAMLConfig,
                                            MARWILConfig, MBMPO, MBMPOConfig,
                                            PPOConfig, QMix, QMixConfig,
                                            R2D2Config, SACConfig, SlateQ,
                                            SlateQConfig, TD3Config)

__all__ = [
    "SampleBatch", "MultiAgentBatch", "convert_ma_batch_to_sample_batch",
    "Box", "Discrete", "CartPoleEnv", "PendulumEnv", "PixelCatcher",
    "VectorEnv", "make_env", "MLPNet", "AtariCNN", "make_model",
    "params_from_flax", "TorchPolicy", "compute_advantages",
    "ReplayBuffer", "PrioritizedReplayBuffer",
    "RolloutWorker", "MultiAgentRolloutWorker", "WorkerSet",
    "synchronous_parallel_sample",
    "Algorithm", "AlgorithmConfig", "PPO", "PPOConfig", "DQN",
    "DQNConfig", "IMPALA", "IMPALAConfig", "SAC", "SACConfig", "DDPG",
    "DDPGConfig", "TD3", "TD3Config", "BC", "BCConfig", "MARWIL",
    "MARWILConfig", "CQL", "CQLConfig", "CRR", "CRRConfig", "JsonReader",
    "JsonWriter", "LocalAlgorithm", "R2D2", "R2D2Config", "DT", "DTConfig",
    "BanditLinUCB", "BanditLinUCBConfig", "BanditLinTS",
    "BanditLinTSConfig", "SlateQ", "SlateQConfig", "QMix", "QMixConfig",
    "MADDPG", "MADDPGConfig", "MAML", "MAMLConfig", "MBMPO", "MBMPOConfig",
    "StackedMLP", "stacked_params_from_flax", "policy_map_from_flax",
    "Dreamer", "DreamerConfig",
    "AlphaZero", "AlphaZeroConfig", "AlphaStar", "AlphaStarConfig",
    "MultiAgentEnv", "MultiAgentCartPole",
    "Connector", "ConnectorPipeline", "FlattenObsConnector",
    "MeanStdObsConnector", "ClipActionConnector", "LambdaConnector",
    "GrayscaleObsConnector", "ResizeObsConnector", "FrameStackConnector",
    "RLModule", "RLModuleSpec", "MultiRLModule", "Learner",
    "PPOLearner", "LearnerGroup", "A3C", "A3CConfig", "DDPPO",
    "DDPPOConfig", "ApexDQN", "ApexDQNConfig", "ApexDDPG", "ApexDDPGConfig",
    "ES", "ESConfig", "ARS", "ARSConfig",
]
