"""AlphaStar-style league self-play training.

Reference analogue: rllib/algorithms/alpha_star/ (league-based
training: a LEAGUE of policies — main agents, main exploiters, league
exploiters, frozen historical snapshots — matched by prioritized
fictitious self-play over a payoff matrix; distributed_learners.py +
league_builder.py). The full game there is StarCraft; the
architecturally distinct machinery is the LEAGUE: PFSP matchmaking,
exploiter roles, periodic snapshotting, and a win-rate payoff table —
reproduced here on the in-repo two-player board games (alpha_zero.py's
TicTacToe/Connect4) with REINFORCE-with-baseline updates per learnable
player.

Counterpart of ``ray_tpu/rllib/algorithms/alpha_star.py`` with the same
league, matchmaking, update and defaults. The league bookkeeping
(``LeaguePlayer``, the roles, ``pfsp_weights``, the payoff table) is
host code, copied. Each player's ``_PolicyNet`` (``Dense_0``/``Dense_1``
ReLU, ``Dense_2`` the logits, ``Dense_3`` the value; flax's names, so a
JAX tree loads with ``models.params_from_flax``) lives on
``config["device"]`` ("cuda" unless the caller asks for "cpu"), and each
learnable player has its own Adam:

- ``_act`` runs one forward, reads the logits to the host in f64, masks
  the illegal moves and draws with ``self._np_rng.choice`` (or takes the
  argmax), as JAX does;
- one update per game on the learner's trajectory: -mean(log π(a) ·
  adv.detach()) + ``vf_coeff`` · mean(adv²) - ``entropy_coeff`` · H,
  adv = return - value;
- a snapshot of main is a detached CLONE with no optimizer: main is
  stepped in place, so a snapshot that shared its tensors would follow
  it (JAX's snapshot shares main's immutable tree, which is the same
  thing there).

The checkpoint holds the whole league as host copies (roster, each
player's weights and Adam state, the payoff table, the snapshot counter
and the counters); ``load_checkpoint`` rebuilds every net and optimizer
on the device. ``step`` (and ``train``) also reports ``timers``: the
host milliseconds of one iteration spent playing, learning and in the
two evaluations against a random player.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.rllib.algorithm import AlgorithmConfig, LocalAlgorithm
from ray_tpu_torch.rllib.algorithms.alpha_zero import GAMES
from ray_tpu_torch.rllib.algorithms.sac import init_dense_
from ray_tpu_torch.rllib.policy import (host_copy, load_weights,
                                        policy_device, weights_of)

MAIN = "main"
MAIN_EXPLOITER = "main_exploiter"
LEAGUE_EXPLOITER = "league_exploiter"
HISTORICAL = "historical"


class _PolicyNet(nn.Module):
    def __init__(self, obs_dim: int, num_actions: int, hidden: int):
        super().__init__()
        self.Dense_0 = nn.Linear(obs_dim, hidden)
        self.Dense_1 = nn.Linear(hidden, hidden)
        self.Dense_2 = nn.Linear(hidden, num_actions)
        self.Dense_3 = nn.Linear(hidden, 1)

    def forward(self, x):
        h = F.relu(self.Dense_0(x))
        h = F.relu(self.Dense_1(h))
        return self.Dense_2(h), self.Dense_3(h)[..., 0]


class LeaguePlayer:
    """One league member (reference: league_builder.py Player*). Its
    ``params`` is its net on the device."""

    def __init__(self, pid: str, ptype: str, params):
        self.pid = pid
        self.ptype = ptype
        self.params = params
        self.games = 0

    @property
    def learnable(self) -> bool:
        return self.ptype != HISTORICAL


def pfsp_weights(win_rates: np.ndarray, mode: str = "squared"
                 ) -> np.ndarray:
    """Prioritized fictitious self-play opponent weighting (reference:
    alpha_star/league_builder.py pfsp): weight opponents the learner
    does NOT reliably beat. ``win_rates`` are the LEARNER's win rates
    vs each candidate."""
    p = np.clip(win_rates, 0.0, 1.0)
    if mode == "squared":
        w = (1.0 - p) ** 2
    elif mode == "variance":
        w = p * (1.0 - p)
    else:
        w = 1.0 - p
    w = w + 1e-3  # never fully starve an opponent
    return w / w.sum()


class AlphaStarConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or AlphaStar)
        self._config.update({
            "env": "tictactoe",
            "hidden": 64,
            "lr": 3e-3,
            "gamma": 1.0,
            "matches_per_iter": 64,
            "entropy_coeff": 0.01,
            "vf_coeff": 0.5,
            # league shape (reference defaults scaled to one process)
            "num_main_exploiters": 1,
            "num_league_exploiters": 1,
            "snapshot_interval": 10,   # iterations between main snapshots
            "max_historical": 8,
            # matchmaking mix for the main agent (reference: 35% SP /
            # 50% PFSP / 15% exploiter-targeting)
            "main_self_play_prob": 0.35,
            "payoff_ema": 0.05,
        })


class AlphaStar(LocalAlgorithm):
    """League training loop: sample matches by PFSP, update the
    learnable participant on each game, snapshot main periodically."""

    _default_config_cls = AlphaStarConfig

    def setup(self, config):
        base = self.get_default_config().to_dict()
        base.update(config or {})
        self.config = cfg = base
        game_cls = GAMES.get(cfg["env"])
        if game_cls is None:
            raise ValueError(
                f"AlphaStar env must be one of {sorted(GAMES)}")
        self.game = game_cls()
        self.device = policy_device(cfg)
        self._init_gen = torch.Generator().manual_seed(cfg.get("seed") or 0)
        # the league (reference: league_builder.py __init__): one main,
        # N main exploiters, M league exploiters; separate param sets
        self.league: Dict[str, LeaguePlayer] = {}
        self.league[MAIN] = LeaguePlayer(MAIN, MAIN, self._fresh_net())
        for i in range(cfg["num_main_exploiters"]):
            pid = f"{MAIN_EXPLOITER}_{i}"
            self.league[pid] = LeaguePlayer(pid, MAIN_EXPLOITER,
                                            self._fresh_net())
        for i in range(cfg["num_league_exploiters"]):
            pid = f"{LEAGUE_EXPLOITER}_{i}"
            self.league[pid] = LeaguePlayer(pid, LEAGUE_EXPLOITER,
                                            self._fresh_net())
        # payoff[a][b] = EMA win rate of a against b (reference: the
        # league's payoff matrix driving PFSP)
        self.payoff: Dict[str, Dict[str, float]] = {}
        self._opt_states: Dict[str, torch.optim.Optimizer] = {
            pid: self._adam(p.params)
            for pid, p in self.league.items() if p.learnable}
        self._snapshots = 0
        # each learner's last loss, kept on the device (no host read)
        self.last_losses: Dict[str, torch.Tensor] = {}
        self._init_local_state()
        self._surface()

    def _fresh_net(self) -> nn.Module:
        return init_dense_(_PolicyNet(
            int(np.prod(self.game.obs_shape)), self.game.num_actions,
            self.config["hidden"]), self._init_gen).to(self.device)

    def _adam(self, net) -> torch.optim.Optimizer:
        return torch.optim.Adam(net.parameters(), lr=self.config["lr"],
                                eps=1e-8)

    def _surface(self):
        """LocalAlgorithm's checkpoint surface: main's net and Adam."""
        self.model = self.league[MAIN].params
        self.target_model = None
        self.optimizer = self._opt_states[MAIN]

    # -------------------------------------------------------------- play

    @torch.no_grad()
    def _act(self, params, state, greedy: bool = False
             ) -> Tuple[int, np.ndarray]:
        g = self.game
        obs = g.observation(state)
        logits, _ = params(torch.as_tensor(obs[None], device=self.device))
        logits = logits[0].cpu().numpy().astype(np.float64)
        legal = g.legal_actions(state)
        mask = np.full_like(logits, -np.inf)
        mask[legal] = 0.0
        logits = logits + mask
        if greedy:
            return int(np.argmax(logits)), obs
        z = logits - logits.max()
        p = np.exp(z) / np.exp(z).sum()
        return int(self._np_rng.choice(len(p), p=p)), obs

    def _play_game(self, pa, pb) -> Tuple[float, List, List]:
        """One game, player a moves first. Returns (outcome for a in
        {1, 0.5, 0}, a's trajectory, b's trajectory) where each
        trajectory is [(obs, action)]."""
        g = self.game
        state = g.initial_state()
        trajs = ([], [])
        params = (pa, pb)
        mover = 0
        while True:
            tv = g.terminal_value(state)
            if tv is not None:
                # tv is from the perspective of the player TO MOVE
                # (-1 = previous mover won, 0 = draw)
                if tv == 0.0:
                    return 0.5, trajs[0], trajs[1]
                winner = 1 - mover  # previous mover
                return (1.0 if winner == 0 else 0.0,
                        trajs[0], trajs[1])
            a, obs = self._act(params[mover], state)
            trajs[mover].append((obs, a))
            state = g.next_state(state, a)
            mover = 1 - mover

    # ---------------------------------------------------------- learning

    def _update(self, net, optimizer, obs, actions, returns
                ) -> torch.Tensor:
        """One Adam step of ``net`` on numpy (or tensor) ``obs`` [n,
        obs], ``actions`` [n], ``returns`` [n]. Returns the loss on the
        device; the grads stay in the params' ``.grad``."""
        cfg = self.config
        obs = torch.as_tensor(obs, dtype=torch.float32, device=self.device)
        actions = torch.as_tensor(actions, device=self.device).long()
        returns = torch.as_tensor(returns, dtype=torch.float32,
                                  device=self.device)
        logits, values = net(obs)
        logp = F.log_softmax(logits, dim=-1)
        chosen = torch.gather(logp, 1, actions[:, None])[:, 0]
        adv = returns - values
        pg = -torch.mean(chosen * adv.detach())
        vf = torch.mean(adv ** 2)
        ent = -torch.mean(torch.sum(torch.exp(logp) * logp, dim=1))
        loss = pg + cfg["vf_coeff"] * vf - cfg["entropy_coeff"] * ent
        params = list(net.parameters())
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        optimizer.step()
        return loss.detach()

    def _learn_from(self, pid: str, traj: List, outcome: float):
        if not traj:
            return
        player = self.league[pid]
        ret = 2.0 * outcome - 1.0  # {0, 0.5, 1} -> {-1, 0, +1}
        obs = np.stack([o for o, _ in traj])
        actions = np.array([a for _, a in traj], np.int64)
        returns = np.full((len(traj),), ret, np.float32)
        self.last_losses[pid] = self._update(
            player.params, self._opt_states[pid], obs, actions, returns)

    # -------------------------------------------------------- matchmaking

    def _win_rate(self, a: str, b: str) -> float:
        return self.payoff.get(a, {}).get(b, 0.5)

    def _record(self, a: str, b: str, outcome_a: float):
        ema = self.config["payoff_ema"]
        for x, y, o in ((a, b, outcome_a), (b, a, 1.0 - outcome_a)):
            cur = self.payoff.setdefault(x, {}).get(y, 0.5)
            self.payoff[x][y] = (1 - ema) * cur + ema * o

    def _choose_opponent(self, pid: str) -> str:
        """Reference league_builder.get_match: mains mix self-play with
        PFSP over the whole league; main exploiters target the current
        main; league exploiters PFSP over everyone."""
        player = self.league[pid]
        others = [q for q in self.league if q != pid]
        if player.ptype == MAIN_EXPLOITER:
            return MAIN
        if player.ptype == MAIN and \
                self._np_rng.random() < self.config["main_self_play_prob"]:
            return MAIN  # self-play
        rates = np.array([self._win_rate(pid, q) for q in others])
        return str(self._np_rng.choice(
            others, p=pfsp_weights(rates)))

    def _snapshot_main(self):
        pid = f"{HISTORICAL}_{self._snapshots}"
        # a clone: main's params are stepped in place
        frozen = copy.deepcopy(self.league[MAIN].params).requires_grad_(False)
        self.league[pid] = LeaguePlayer(pid, HISTORICAL, frozen)
        self._snapshots += 1
        hist = [p for p in self.league.values()
                if p.ptype == HISTORICAL]
        if len(hist) > self.config["max_historical"]:
            oldest = min(hist, key=lambda p: int(p.pid.rsplit("_", 1)[-1]))
            del self.league[oldest.pid]
            # the payoff table must not accrete dead opponents
            self.payoff.pop(oldest.pid, None)
            for row in self.payoff.values():
                row.pop(oldest.pid, None)

    # ------------------------------------------------------- training loop

    def step(self) -> Dict[str, Any]:
        cfg = self.config
        learners = [pid for pid, p in self.league.items() if p.learnable]
        games = 0
        play_s = learn_s = 0.0
        for i in range(cfg["matches_per_iter"]):
            t0 = time.perf_counter()
            pid = learners[i % len(learners)]
            opp = self._choose_opponent(pid)
            first = bool(self._np_rng.integers(2))
            pa, pb = (pid, opp) if first else (opp, pid)
            out_a, ta, tb = self._play_game(self.league[pa].params,
                                            self.league[pb].params)
            out_for_pid = out_a if first else 1.0 - out_a
            traj = ta if first else tb
            t1 = time.perf_counter()
            self._learn_from(pid, traj, out_for_pid)
            t2 = time.perf_counter()
            if opp != pid:
                self._record(pid, opp, out_for_pid)
            self.league[pid].games += 1
            games += 1
            play_s += (t1 - t0) + (time.perf_counter() - t2)
            learn_s += t2 - t1
        self._iteration += 1
        self._timesteps_total += games
        if self._iteration % cfg["snapshot_interval"] == 0:
            self._snapshot_main()
        self._surface()
        t3 = time.perf_counter()
        # in JAX's order: the 4-game evaluation, then the 20-game one
        reward_mean = 2.0 * self.eval_vs_random(MAIN, 4) - 1.0
        win_rate = self.eval_vs_random(MAIN, 20)
        eval_s = time.perf_counter() - t3
        return {
            "training_iteration": self._iteration,
            "timesteps_total": self._timesteps_total,
            "num_env_steps_sampled": self._timesteps_total,
            "episodes_this_iter": games,
            "episode_reward_mean": reward_mean,
            "league_size": len(self.league),
            "num_historical": sum(1 for p in self.league.values()
                                  if p.ptype == HISTORICAL),
            "main_vs_random_win_rate": win_rate,
            "payoff_main": dict(self.payoff.get(MAIN, {})),
            "time_total_s": time.time() - self._t_start,
            "timers": {"play_time_ms": play_s * 1e3,
                       "learn_time_ms": learn_s * 1e3,
                       "eval_time_ms": eval_s * 1e3},
        }

    train = step  # Tune surface

    # ---------------------------------------------------------- checkpoint

    def save_checkpoint(self) -> Dict[str, Any]:
        """The league IS the training state: every player's params,
        the payoff matrix, and the snapshot counter resume together
        (reference: the league checkpoints its whole roster)."""
        return {
            "league": {pid: {"ptype": p.ptype, "games": p.games,
                             "params": weights_of(p.params)}
                       for pid, p in self.league.items()},
            "opt_states": {pid: host_copy(o.state_dict())
                           for pid, o in self._opt_states.items()},
            "payoff": {a: dict(r) for a, r in self.payoff.items()},
            "snapshots": self._snapshots,
            "iteration": self._iteration,
            "timesteps_total": self._timesteps_total,
        }

    def load_checkpoint(self, state: Dict[str, Any]):
        self.league = {}
        for pid, ent in state["league"].items():
            net = self._fresh_net()
            load_weights(net, ent["params"])
            if ent["ptype"] == HISTORICAL:
                net.requires_grad_(False)
            self.league[pid] = LeaguePlayer(pid, ent["ptype"], net)
            self.league[pid].games = ent.get("games", 0)
        self._opt_states = {}
        for pid, s in state["opt_states"].items():
            self._opt_states[pid] = self._adam(self.league[pid].params)
            self._opt_states[pid].load_state_dict(host_copy(s))
        self.payoff = {a: dict(r) for a, r in state["payoff"].items()}
        self._snapshots = state["snapshots"]
        self._iteration = state["iteration"]
        self._timesteps_total = state["timesteps_total"]
        self._surface()

    # ---------------------------------------------------------- evaluation

    def _random_move(self, state) -> int:
        legal = self.game.legal_actions(state)
        return int(self._np_rng.choice(legal))

    def eval_vs_random(self, pid: str, n_games: int = 20) -> float:
        """Win rate (draws = 0.5) of ``pid`` against a uniform-random
        player, alternating first move."""
        g = self.game
        total = 0.0
        params = self.league[pid].params
        for i in range(n_games):
            state = g.initial_state()
            me_first = i % 2 == 0
            mover_is_me = me_first
            while True:
                tv = g.terminal_value(state)
                if tv is not None:
                    if tv == 0.0:
                        total += 0.5
                    else:
                        # previous mover won
                        total += 0.0 if mover_is_me else 1.0
                    break
                if mover_is_me:
                    a, _ = self._act(params, state, greedy=True)
                else:
                    a = self._random_move(state)
                state = g.next_state(state, a)
                mover_is_me = not mover_is_me
        return total / n_games
