"""The port's RL algorithms, every one of ``ray_tpu/rllib/algorithms/``
under the JAX registry's names: PPO, DDPPO, IMPALA/APPO, DQN/SimpleQ,
Ape-X DQN and DDPG, PG/A2C, A3C, SAC, DDPG/TD3, BC/MARWIL, CQL, CRR,
ES/ARS, the bandits (LinUCB, LinTS), R2D2, DT, SlateQ, QMIX, MADDPG,
MAML, MBMPO, Dreamer, AlphaZero and AlphaStar. DDPPO, Ape-X, A3C, ES/ARS
and IMPALA/APPO's async branch run their workers as actors of the
port's runtime."""

from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig, PPOPolicy
from ray_tpu_torch.rllib.algorithms.ddppo import DDPPO, DDPPOConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig, DQNPolicy
from ray_tpu_torch.rllib.algorithms.simple_q import SimpleQ, SimpleQConfig
from ray_tpu_torch.rllib.algorithms.apex_dqn import ApexDQN, ApexDQNConfig
from ray_tpu_torch.rllib.algorithms.apex_ddpg import ApexDDPG, ApexDDPGConfig
from ray_tpu_torch.rllib.algorithms.impala import (IMPALA, IMPALAConfig,
                                                   IMPALAPolicy)
from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig, APPOPolicy
from ray_tpu_torch.rllib.algorithms.pg import (A2C, A2CConfig, A2CPolicy, PG,
                                               PGConfig, PGPolicy)
from ray_tpu_torch.rllib.algorithms.a3c import A3C, A3CConfig
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig, SACPolicy
from ray_tpu_torch.rllib.algorithms.ddpg import (DDPG, DDPGConfig,
                                                 DDPGPolicy, TD3, TD3Config)
from ray_tpu_torch.rllib.algorithms.bc import (BC, BCConfig, MARWIL,
                                               MARWILConfig, MARWILPolicy)
from ray_tpu_torch.rllib.algorithms.cql import CQL, CQLConfig, CQLPolicy
from ray_tpu_torch.rllib.algorithms.crr import CRR, CRRConfig, CRRPolicy
from ray_tpu_torch.rllib.algorithms.es import ARS, ARSConfig, ES, ESConfig
from ray_tpu_torch.rllib.algorithms.r2d2 import R2D2, R2D2Config
from ray_tpu_torch.rllib.algorithms.dt import DT, DTConfig
from ray_tpu_torch.rllib.algorithms.bandit import (BanditLinTS,
                                                   BanditLinTSConfig,
                                                   BanditLinUCB,
                                                   BanditLinUCBConfig)
from ray_tpu_torch.rllib.algorithms.slateq import SlateQ, SlateQConfig
from ray_tpu_torch.rllib.algorithms.qmix import QMix, QMixConfig
from ray_tpu_torch.rllib.algorithms.maddpg import MADDPG, MADDPGConfig
from ray_tpu_torch.rllib.algorithms.maml import MAML, MAMLConfig
from ray_tpu_torch.rllib.algorithms.mbmpo import MBMPO, MBMPOConfig
from ray_tpu_torch.rllib.algorithms.dreamer import Dreamer, DreamerConfig
from ray_tpu_torch.rllib.algorithms.alpha_zero import (AlphaZero,
                                                       AlphaZeroConfig)
from ray_tpu_torch.rllib.algorithms.alpha_star import (AlphaStar,
                                                       AlphaStarConfig)

__all__ = ["PPO", "PPOConfig", "PPOPolicy", "DDPPO", "DDPPOConfig",
           "ApexDQN", "ApexDQNConfig", "ApexDDPG", "ApexDDPGConfig", "ES",
           "ESConfig", "ARS", "ARSConfig",
           "DQN", "DQNConfig", "DQNPolicy",
           "SimpleQ", "SimpleQConfig", "IMPALA", "IMPALAConfig",
           "IMPALAPolicy", "APPO", "APPOConfig", "APPOPolicy", "PG",
           "PGConfig", "PGPolicy", "A2C", "A2CConfig", "A2CPolicy", "A3C",
           "A3CConfig", "SAC", "SACConfig", "SACPolicy", "DDPG",
           "DDPGConfig", "DDPGPolicy", "TD3", "TD3Config", "BC", "BCConfig",
           "MARWIL", "MARWILConfig", "MARWILPolicy", "CQL", "CQLConfig",
           "CQLPolicy", "CRR", "CRRConfig", "CRRPolicy", "R2D2",
           "R2D2Config", "DT", "DTConfig", "BanditLinUCB",
           "BanditLinUCBConfig", "BanditLinTS", "BanditLinTSConfig",
           "SlateQ", "SlateQConfig", "QMix", "QMixConfig", "MADDPG",
           "MADDPGConfig", "MAML", "MAMLConfig", "MBMPO", "MBMPOConfig",
           "Dreamer", "DreamerConfig", "AlphaZero", "AlphaZeroConfig",
           "AlphaStar", "AlphaStarConfig"]
