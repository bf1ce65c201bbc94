"""AlphaZero — self-play MCTS + policy/value network.

Reference analogue: rllib/algorithms/alpha_zero/ (alpha_zero.py,
mcts.py, alpha_zero_policy.py; Silver et al. 2017): a PUCT tree search
guided by a policy/value net, self-play games generating (state,
visit-count policy, outcome) targets, and a cross-entropy + value-MSE
update.

Counterpart of ``ray_tpu/rllib/algorithms/alpha_zero.py``. The games
(``BoardGame``, ``TicTacToe``, ``Connect4``, ``GAMES``) and the PUCT
search (``_Node``, ``MCTS``) are numpy on the host, copied as they are:
``evaluate(obs) -> (logits, values)`` is their only contact with the
net. ``_PVNet`` (``Dense_0``/``Dense_1`` 128 ReLU, ``Dense_2`` the
logits, ``tanh`` of ``Dense_3`` the value; flax's names, so the JAX
tree loads with ``models.params_from_flax``) and its Adam live on
``config["device"]`` ("cuda" unless the caller asks for "cpu"):

- ``_evaluate`` runs ONE position per call on the device and reads
  logits and value back in one transfer, as JAX's search does: the tree
  is walked one leaf at a time, so batching across it would change the
  search;
- one update is CE(pi, log_softmax) + MSE(value, z) + ``l2_coeff`` ·
  Σ w² over every param, biases included, then Adam;
- the Dirichlet noise, the move draws and the replay indices come from
  ``self._np_rng``, in JAX's order.

``training_step`` also reports ``timers``: the host milliseconds of one
iteration spent in self-play (the search and its net evaluations),
gathering replay batches and learning; ``self.evaluations`` counts the
net's calls.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.rllib.algorithm import AlgorithmConfig, LocalAlgorithm
from ray_tpu_torch.rllib.algorithms.sac import init_dense_
from ray_tpu_torch.rllib.policy import policy_device, stats_to_host


# --------------------------------------------------------------- board games


class BoardGame:
    """Two-player zero-sum perfect-information game. States are numpy
    arrays; player +1 moves first; values are from the PERSPECTIVE OF
    THE PLAYER TO MOVE."""

    num_actions: int
    obs_shape: Tuple[int, ...]

    def initial_state(self): ...
    def legal_actions(self, state) -> np.ndarray: ...
    def next_state(self, state, action): ...
    def terminal_value(self, state) -> Optional[float]:
        """None if non-terminal, else the value for the player to move
        (-1 lost, 0 draw; +1 cannot occur — the mover faces the result
        of the opponent's winning move)."""
    def observation(self, state) -> np.ndarray:
        """Canonical obs from the mover's perspective."""


class TicTacToe(BoardGame):
    """3x3; state = (board(9) ints in {-1,0,1}, player-to-move)."""

    num_actions = 9
    obs_shape = (18,)
    _LINES = [(0, 1, 2), (3, 4, 5), (6, 7, 8), (0, 3, 6), (1, 4, 7),
              (2, 5, 8), (0, 4, 8), (2, 4, 6)]

    def initial_state(self):
        return (np.zeros(9, np.int8), 1)

    def legal_actions(self, state):
        return np.flatnonzero(state[0] == 0)

    def next_state(self, state, action):
        board, player = state
        nb = board.copy()
        nb[action] = player
        return (nb, -player)

    def terminal_value(self, state):
        board, player = state
        for a, b, c in self._LINES:
            s = board[a] + board[b] + board[c]
            if s == 3 or s == -3:
                # the line belongs to the player who just moved
                return -1.0
        if not (board == 0).any():
            return 0.0
        return None

    def observation(self, state):
        board, player = state
        mine = (board == player).astype(np.float32)
        theirs = (board == -player).astype(np.float32)
        return np.concatenate([mine, theirs])


class Connect4(BoardGame):
    """6x7 connect-four; state = (board(6,7), player)."""

    ROWS, COLS, K = 6, 7, 4
    num_actions = 7
    obs_shape = (2 * 6 * 7,)

    def initial_state(self):
        return (np.zeros((self.ROWS, self.COLS), np.int8), 1)

    def legal_actions(self, state):
        return np.flatnonzero(state[0][0] == 0)

    def next_state(self, state, action):
        board, player = state
        nb = board.copy()
        col = nb[:, action]
        row = np.flatnonzero(col == 0)[-1]  # lowest empty cell
        nb[row, action] = player
        return (nb, -player)

    def terminal_value(self, state):
        board, player = state
        b = board
        for who in (1, -1):
            m = (b == who)
            # horizontal / vertical / two diagonals via shifted ANDs
            if (m[:, :-3] & m[:, 1:-2] & m[:, 2:-1] & m[:, 3:]).any() or \
               (m[:-3] & m[1:-2] & m[2:-1] & m[3:]).any() or \
               (m[:-3, :-3] & m[1:-2, 1:-2] & m[2:-1, 2:-1]
                & m[3:, 3:]).any() or \
               (m[3:, :-3] & m[2:-1, 1:-2] & m[1:-2, 2:-1]
                & m[:-3, 3:]).any():
                return -1.0  # the line belongs to the previous mover
        if not (b == 0).any():
            return 0.0
        return None

    def observation(self, state):
        board, player = state
        mine = (board == player).astype(np.float32).ravel()
        theirs = (board == -player).astype(np.float32).ravel()
        return np.concatenate([mine, theirs])


GAMES = {"tictactoe": TicTacToe, "connect4": Connect4}


# ---------------------------------------------------------------------- MCTS


class _Node:
    __slots__ = ("state", "prior", "children", "n", "w", "legal",
                 "terminal_v")

    def __init__(self, state, prior: float):
        self.state = state
        self.prior = prior
        self.children: Dict[int, "_Node"] = {}
        self.n = 0
        self.w = 0.0
        self.legal: Optional[np.ndarray] = None
        self.terminal_v: Optional[float] = None

    @property
    def q(self) -> float:
        return self.w / self.n if self.n else 0.0


class MCTS:
    """PUCT search (reference: alpha_zero/mcts.py). ``evaluate(obs
    batch) -> (priors, values)`` is the only net touchpoint."""

    def __init__(self, game: BoardGame, evaluate, c_puct: float = 1.5,
                 dirichlet_alpha: float = 0.6,
                 dirichlet_frac: float = 0.25,
                 rng: Optional[np.random.Generator] = None):
        self.game = game
        self.evaluate = evaluate
        self.c_puct = c_puct
        self.alpha = dirichlet_alpha
        self.frac = dirichlet_frac
        self.rng = rng or np.random.default_rng()

    def run(self, state, num_sims: int, add_noise: bool) -> np.ndarray:
        g = self.game
        root = _Node(state, 1.0)
        self._expand(root, add_noise=add_noise)
        for _ in range(num_sims):
            node, path = root, [root]
            # select to a leaf
            while node.children and node.terminal_v is None:
                node = self._select(node)
                path.append(node)
            if node.terminal_v is not None:
                value = node.terminal_v
            else:
                value = self._expand(node, add_noise=False)
            # backup: value is from the leaf mover's perspective; it
            # flips sign at every ply up the path
            for parent in reversed(path):
                parent.n += 1
                parent.w += value
                value = -value
        counts = np.zeros(g.num_actions, np.float32)
        for a, child in root.children.items():
            counts[a] = child.n
        return counts

    def _select(self, node: _Node) -> _Node:
        sqrt_n = float(np.sqrt(node.n + 1))
        best, best_score = None, -np.inf
        for a, child in node.children.items():
            # child.q is from the CHILD mover's perspective — negate
            u = -child.q + self.c_puct * child.prior * sqrt_n / (
                1 + child.n)
            if u > best_score:
                best, best_score = child, u
        return best

    def _expand(self, node: _Node, add_noise: bool) -> float:
        g = self.game
        tv = g.terminal_value(node.state)
        if tv is not None:
            node.terminal_v = tv
            return tv
        legal = g.legal_actions(node.state)
        node.legal = legal
        obs = g.observation(node.state)[None]
        priors, value = self.evaluate(obs)
        priors, value = np.asarray(priors[0]), float(value[0])
        p = np.zeros(g.num_actions, np.float64)
        p[legal] = np.exp(priors[legal] - priors[legal].max())
        p /= p.sum()
        if add_noise:
            noise = self.rng.dirichlet([self.alpha] * len(legal))
            p[legal] = (1 - self.frac) * p[legal] + self.frac * noise
        for a in legal:
            node.children[int(a)] = _Node(
                g.next_state(node.state, int(a)), float(p[a]))
        return value


# ----------------------------------------------------------------- algorithm


class _PVNet(nn.Module):
    def __init__(self, obs_dim: int, num_actions: int, hidden: int = 128):
        super().__init__()
        self.Dense_0 = nn.Linear(obs_dim, hidden)
        self.Dense_1 = nn.Linear(hidden, hidden)
        self.Dense_2 = nn.Linear(hidden, num_actions)
        self.Dense_3 = nn.Linear(hidden, 1)

    def forward(self, obs):
        x = F.relu(self.Dense_0(obs))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x), torch.tanh(self.Dense_3(x))[..., 0]


class AlphaZeroConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or AlphaZero)
        self._config.update({
            "env": "tictactoe",
            "num_sims": 25,
            "c_puct": 1.5,
            "dirichlet_alpha": 0.6,
            "dirichlet_frac": 0.25,
            "temperature_moves": 4,  # sample moves while ply < this
            "games_per_iteration": 24,
            "train_batch_size": 256,
            "sgd_iters": 8,
            "lr": 3e-3,
            "l2_coeff": 1e-4,
            "replay_capacity": 20_000,
            "hidden": 128,
        })


class AlphaZero(LocalAlgorithm):
    """Self-play AlphaZero (reference: alpha_zero.py training_step:
    self-play sample → replay → SGD on CE+MSE)."""

    _default_config_cls = AlphaZeroConfig

    def setup(self, config):
        base = self.get_default_config().to_dict()
        base.update(config or {})
        self.config = cfg = base
        game_cls = GAMES.get(cfg["env"])
        if game_cls is None:
            raise ValueError(
                f"AlphaZero env must be one of {sorted(GAMES)}")
        self.game = game_cls()
        self.device = policy_device(cfg)
        init_gen = torch.Generator().manual_seed(cfg.get("seed") or 0)
        self.model = init_dense_(
            _PVNet(int(np.prod(self.game.obs_shape)),
                   self.game.num_actions, cfg["hidden"]),
            init_gen).to(self.device)
        self.target_model = None  # the checkpoint saves params twice
        self.optimizer = torch.optim.Adam(self.model.parameters(),
                                          lr=cfg["lr"], eps=1e-8)
        self._replay: List[Tuple[np.ndarray, np.ndarray, float]] = []
        self.evaluations = 0
        self._init_local_state()

    @torch.no_grad()
    def _evaluate(self, obs):
        self.evaluations += 1
        x = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        logits, value = self.model(x)
        out = torch.cat([logits, value[:, None]], -1).cpu().numpy()
        return out[:, :-1], out[:, -1]

    def _self_play_game(self) -> Tuple[List, float]:
        g, cfg = self.game, self.config
        mcts = MCTS(g, self._evaluate, cfg["c_puct"],
                    cfg["dirichlet_alpha"], cfg["dirichlet_frac"],
                    rng=self._np_rng)
        state = g.initial_state()
        history = []  # (obs, pi, mover_sign)
        ply = 0
        while True:
            tv = g.terminal_value(state)
            if tv is not None:
                # tv is for the player to move at the terminal state
                outcome_for_mover = tv
                break
            counts = mcts.run(state, cfg["num_sims"], add_noise=True)
            pi = counts / counts.sum()
            history.append((g.observation(state), pi, ply))
            if ply < cfg["temperature_moves"]:
                action = int(self._np_rng.choice(len(pi), p=pi))
            else:
                action = int(np.argmax(pi))
            state = g.next_state(state, action)
            ply += 1
        # assign z to every position from ITS mover's perspective:
        # the terminal mover sees `tv`; signs alternate backwards
        samples = []
        for obs, pi, p_ply in history:
            sign = 1.0 if (ply - p_ply) % 2 == 0 else -1.0
            samples.append((obs, pi, sign * outcome_for_mover))
        return samples, outcome_for_mover

    def _update(self, obs, pi, z) -> Dict[str, torch.Tensor]:
        """One Adam step on numpy (or tensor) ``obs`` [B, obs], ``pi`` [B,
        A], ``z`` [B]. Returns the stats as tensors on the device; the
        grads stay in the params' ``.grad``."""
        obs, pi, z = (torch.as_tensor(v, dtype=torch.float32,
                                      device=self.device)
                      for v in (obs, pi, z))
        logits, value = self.model(obs)
        logp = F.log_softmax(logits, dim=-1)
        policy_loss = -torch.mean(torch.sum(pi * logp, dim=-1))
        value_loss = torch.mean((value - z) ** 2)
        params = list(self.model.parameters())
        l2 = sum(torch.sum(w ** 2) for w in params)
        total = policy_loss + value_loss + self.config["l2_coeff"] * l2
        for p, g in zip(params, torch.autograd.grad(total, params)):
            p.grad = g
        self.optimizer.step()
        return {"total_loss": total.detach(),
                "policy_loss": policy_loss.detach(),
                "value_loss": value_loss.detach()}

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        n_steps = 0
        for _ in range(cfg["games_per_iteration"]):
            samples, outcome = self._self_play_game()
            self._replay.extend(samples)
            n_steps += len(samples)
            self._episode_reward_window.append(outcome)
        self._replay = self._replay[-cfg["replay_capacity"]:]
        self._timesteps_total += n_steps
        search_s = time.perf_counter() - t0
        stats: Dict[str, float] = {}
        replay_s = learn_s = 0.0
        if self._replay:
            for _ in range(cfg["sgd_iters"]):
                t1 = time.perf_counter()
                idx = self._np_rng.integers(
                    0, len(self._replay),
                    min(cfg["train_batch_size"], len(self._replay)))
                obs = np.stack([self._replay[i][0] for i in idx])
                pi = np.stack([self._replay[i][1] for i in idx])
                z = np.asarray([self._replay[i][2] for i in idx],
                               np.float32)
                t2 = time.perf_counter()
                dev_stats = self._update(obs, pi, z)
                replay_s += t2 - t1
                learn_s += time.perf_counter() - t2
            t3 = time.perf_counter()
            stats = stats_to_host(dev_stats)
            learn_s += time.perf_counter() - t3
        return {
            "num_env_steps_sampled_this_iter": n_steps,
            "replay_size": len(self._replay),
            **{f"learner/{k}": v for k, v in stats.items()},
            "timers": {"search_time_ms": search_s * 1e3,
                       "replay_time_ms": replay_s * 1e3,
                       "learn_time_ms": learn_s * 1e3},
        }

    # ---- evaluation helpers ----

    def compute_action(self, state, num_sims: Optional[int] = None):
        """Best move by search (deployment path)."""
        mcts = MCTS(self.game, self._evaluate, self.config["c_puct"],
                    rng=self._np_rng)
        counts = mcts.run(state, num_sims or self.config["num_sims"],
                          add_noise=False)
        return int(np.argmax(counts))

    def policy_action(self, state) -> int:
        """Raw-net argmax move (no search) — isolates what the NET
        learned for learning tests."""
        legal = self.game.legal_actions(state)
        logits, _ = self._evaluate(self.game.observation(state)[None])
        masked = np.full(self.game.num_actions, -np.inf)
        masked[legal] = logits[0][legal]
        return int(np.argmax(masked))

    def play_vs_random(self, episodes: int = 20, use_search: bool = False,
                       seed: int = 0) -> Dict[str, float]:
        """Pit the agent (as BOTH colors alternately) against a uniform
        random opponent; returns win/draw/loss rates."""
        g = self.game
        rng = np.random.default_rng(seed)
        w = d = losses = 0
        for ep in range(episodes):
            agent_player = 1 if ep % 2 == 0 else -1
            state = g.initial_state()
            while True:
                tv = g.terminal_value(state)
                if tv is not None:
                    mover = state[1]
                    # tv is for the player to move; translate to agent
                    res = tv if mover == agent_player else -tv
                    if res > 0:
                        w += 1
                    elif res == 0:
                        d += 1
                    else:
                        losses += 1
                    break
                if state[1] == agent_player:
                    a = (self.compute_action(state) if use_search
                         else self.policy_action(state))
                else:
                    a = int(rng.choice(g.legal_actions(state)))
                state = g.next_state(state, a)
        n = float(episodes)
        return {"win_rate": w / n, "draw_rate": d / n,
                "loss_rate": losses / n}

    def save_checkpoint(self) -> Dict[str, Any]:
        """As JAX's: the net's weights as ``params`` and again as
        ``target_params``, Adam's state and the counters (no replay)."""
        state = super().save_checkpoint()
        state["target_params"] = state["params"]
        return state
