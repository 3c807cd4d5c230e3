"""Replay buffers: uniform ring + proportional prioritized (own copy of
ray_tpu.rl.replay_buffer).

Reference capability: rllib/utils/replay_buffers/ (ReplayBuffer,
PrioritizedEpisodeReplayBuffer — proportional prioritization per
Schaul et al. '15 with importance weights). Redesign: flat numpy ring
buffers keyed by column (obs/actions/rewards/next_obs/dones) — batches go
straight into the update step, which moves them to its device; the prioritized
variant keeps priorities in a numpy array and samples by cumulative-sum
inversion (O(log n) via searchsorted), plenty at host-side buffer sizes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


class ReplayBuffer:
    """Uniform-sampling ring buffer."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self._cols: Optional[Dict[str, np.ndarray]] = None
        self._next = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        data = {k: np.asarray(v) for k, v in batch.items()
                if isinstance(v, (np.ndarray, list))
                and k in ("obs", "actions", "rewards", "next_obs", "dones")}
        n = len(data["obs"])
        if self._cols is None:
            self._cols = {
                k: np.zeros((self.capacity,) + v.shape[1:], v.dtype)
                for k, v in data.items()
            }
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in data.items():
            self._cols[k][idx] = v
        self._on_add(idx)
        self._next = int((self._next + n) % self.capacity)
        self._size = int(min(self._size + n, self.capacity))

    def _on_add(self, idx: np.ndarray) -> None:
        pass

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        assert self._size > 0, "empty buffer"
        idx = self._rng.integers(0, self._size, batch_size)
        return self._gather(idx)

    def _gather(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        out = {k: v[idx] for k, v in self._cols.items()}
        out["indices"] = idx
        return out


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritization: P(i) ~ p_i^alpha, importance weights
    w_i = (N * P(i))^-beta / max w (Schaul et al. '15)."""

    def __init__(self, capacity: int, alpha: float = 0.6, beta: float = 0.4,
                 eps: float = 1e-6, seed: int = 0):
        super().__init__(capacity, seed=seed)
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        self._prior = np.zeros(capacity, np.float64)
        self._max_prior = 1.0

    def _on_add(self, idx: np.ndarray) -> None:
        self._prior[idx] = self._max_prior  # new samples get max priority

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        assert self._size > 0, "empty buffer"
        p = self._prior[: self._size] ** self.alpha
        cum = np.cumsum(p)
        targets = self._rng.random(batch_size) * cum[-1]
        idx = np.minimum(np.searchsorted(cum, targets), self._size - 1)
        out = self._gather(idx)
        probs = p[idx] / cum[-1]
        w = (self._size * probs) ** (-self.beta)
        out["weights"] = (w / w.max()).astype(np.float32)
        return out

    def update_priorities(self, indices: np.ndarray,
                          td_errors: np.ndarray) -> None:
        prior = np.abs(np.asarray(td_errors, np.float64)) + self.eps
        self._prior[np.asarray(indices)] = prior
        self._max_prior = max(self._max_prior, float(prior.max()))
