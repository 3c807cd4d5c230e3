"""Environment interface + built-in envs (own copy of
ray_tpu.rl.env).

Reference capability: rllib/env/ (gym/gymnasium adapters, env registry).
The image bundles no gym, so the API IS the gymnasium core contract —
``reset() -> (obs, info)`` / ``step(a) -> (obs, reward, terminated,
truncated, info)`` — and any real gymnasium env drops in unchanged. Two
built-in envs cover the test/benchmark needs: CartPole (the classic
control benchmark, dynamics per Barto-Sutton-Anderson '83 as in gym's
cartpole.py) and a discrete ChainEnv (exploration stress)."""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register_env(name: str, creator: Callable[..., Any]) -> None:
    """Reference: ray.tune.registry.register_env."""
    _REGISTRY[name] = creator


def make_env(name: str, **kwargs) -> Any:
    if name in _REGISTRY:
        return _REGISTRY[name](**kwargs)
    try:  # a real gymnasium install takes precedence for unknown names
        import gymnasium

        return gymnasium.make(name, **kwargs)
    except ImportError:
        raise ValueError(
            f"unknown env '{name}' and gymnasium is not installed; "
            f"register_env() it (built-ins: {sorted(_REGISTRY)})"
        ) from None


class CartPoleEnv:
    """Classic cart-pole balancing (dynamics identical to gym CartPole-v1:
    4-d observation, 2 discrete actions, +1 reward per step, 500-step cap)."""

    num_actions = 2
    obs_dim = 4

    def __init__(self, max_steps: int = 500, seed: Optional[int] = None):
        self.max_steps = max_steps
        self._rng = np.random.default_rng(seed)
        self._state: Optional[np.ndarray] = None
        self._t = 0

    def reset(self, *, seed: Optional[int] = None) -> Tuple[np.ndarray, dict]:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, 4).astype(np.float32)
        self._t = 0
        return self._state.copy(), {}

    def step(self, action: int):
        assert self._state is not None, "call reset() first"
        x, x_dot, theta, theta_dot = self._state
        force = 10.0 if action == 1 else -10.0
        g, mc, mp, length = 9.8, 1.0, 0.1, 0.5
        total = mc + mp
        pml = mp * length
        costh, sinth = math.cos(theta), math.sin(theta)
        temp = (force + pml * theta_dot ** 2 * sinth) / total
        theta_acc = (g * sinth - costh * temp) / (
            length * (4.0 / 3.0 - mp * costh ** 2 / total))
        x_acc = temp - pml * theta_acc * costh / total
        tau = 0.02
        x += tau * x_dot
        x_dot += tau * x_acc
        theta += tau * theta_dot
        theta_dot += tau * theta_acc
        self._state = np.array([x, x_dot, theta, theta_dot], np.float32)
        self._t += 1
        terminated = bool(abs(x) > 2.4 or abs(theta) > 12 * math.pi / 180)
        truncated = self._t >= self.max_steps
        return self._state.copy(), 1.0, terminated, truncated, {}


class ChainEnv:
    """N-state chain: action 1 walks right (reward at the end), action 0
    resets to start with a small reward — a standard exploration probe."""

    def __init__(self, n: int = 10, max_steps: int = 50,
                 seed: Optional[int] = None):
        self.n = n
        self.num_actions = 2
        self.obs_dim = n
        self.max_steps = max_steps
        self._pos = 0
        self._t = 0

    def _obs(self) -> np.ndarray:
        v = np.zeros(self.n, np.float32)
        v[self._pos] = 1.0
        return v

    def reset(self, *, seed: Optional[int] = None):
        self._pos = 0
        self._t = 0
        return self._obs(), {}

    def step(self, action: int):
        self._t += 1
        if action == 1:
            self._pos = min(self.n - 1, self._pos + 1)
            reward = 10.0 if self._pos == self.n - 1 else 0.0
        else:
            self._pos = 0
            reward = 0.1
        return self._obs(), reward, False, self._t >= self.max_steps, {}


register_env("CartPole-rt", lambda **kw: CartPoleEnv(**kw))
register_env("Chain-rt", lambda **kw: ChainEnv(**kw))
