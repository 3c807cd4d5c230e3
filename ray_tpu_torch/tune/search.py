"""Search spaces + samplers (own copy of ray_tpu.tune.search).

Reference capability: python/ray/tune/search/ (sample.py Domain classes:
Categorical/Float/Integer with uniform/loguniform, grid_search markers,
BasicVariantGenerator grid x random expansion in
search/basic_variant.py). Spaces are declarative markers resolved per
trial by ``generate_trial_configs``.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


@dataclass
class Categorical(Domain):
    categories: Sequence[Any]

    def sample(self, rng: random.Random) -> Any:
        return rng.choice(list(self.categories))


@dataclass
class Float(Domain):
    low: float
    high: float
    log: bool = False

    def sample(self, rng: random.Random) -> float:
        if self.log:
            return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))
        return rng.uniform(self.low, self.high)


@dataclass
class Integer(Domain):
    low: int
    high: int  # exclusive, reference randint semantics

    def sample(self, rng: random.Random) -> int:
        return rng.randrange(self.low, self.high)


@dataclass
class GridSearch:
    values: Sequence[Any]


# ------------------------------------------------------------------ public api
def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def uniform(low: float, high: float) -> Float:
    return Float(low, high)


def loguniform(low: float, high: float) -> Float:
    return Float(low, high, log=True)


def randint(low: int, high: int) -> Integer:
    return Integer(low, high)


def grid_search(values: Sequence[Any]) -> Dict[str, Any]:
    return {"grid_search": list(values)}


# ---------------------------------------------------------------- resolution
def _is_grid(v: Any) -> bool:
    return isinstance(v, dict) and set(v.keys()) == {"grid_search"}


def _grid_axes(space: Dict[str, Any], prefix: tuple = ()) -> List[tuple]:
    axes = []
    for k, v in space.items():
        if _is_grid(v):
            axes.append((prefix + (k,), list(v["grid_search"])))
        elif isinstance(v, dict):
            axes.extend(_grid_axes(v, prefix + (k,)))
    return axes


def _set_path(d: Dict[str, Any], path: tuple, value: Any) -> None:
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = value


def _resolve(space: Any, rng: random.Random) -> Any:
    if isinstance(space, Domain):
        return space.sample(rng)
    if _is_grid(space):
        raise ValueError("grid_search resolved separately")
    if isinstance(space, dict):
        return {k: _resolve(v, rng) for k, v in space.items() if not _is_grid(v)}
    return space


def generate_trial_configs(param_space: Dict[str, Any], num_samples: int,
                           seed: int = 0) -> List[Dict[str, Any]]:
    """Reference semantics (BasicVariantGenerator): the grid is expanded
    exhaustively and the cartesian product is repeated num_samples times,
    with non-grid Domains re-sampled per trial."""
    rng = random.Random(seed)
    axes = _grid_axes(param_space)
    grid_points: List[List[tuple]] = [[]]
    for path, values in axes:
        grid_points = [g + [(path, v)] for g in grid_points for v in values]
    configs = []
    for _ in range(max(1, num_samples)):
        for point in grid_points:
            cfg = _resolve(param_space, rng)
            for path, v in point:
                _set_path(cfg, path, v)
            configs.append(cfg)
    return configs


# ------------------------------------------------------------------ searchers
class Searcher:
    """Sequential search algorithm (reference: tune/search/searcher.py).
    suggest() proposes the next trial's config (None = budget/pool drained
    for now); on_trial_complete() feeds the observation back."""

    def set_search_properties(self, metric: str, mode: str,
                              space: Dict[str, Any]) -> None:
        self.metric = metric
        self.mode = mode
        self.space = space

    def suggest(self, trial_id: str) -> Any:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str,
                          result: Any = None,
                          error: bool = False) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Grid x random expansion as a Searcher (the default strategy)."""

    def __init__(self, num_samples: int = 1, seed: int = 0):
        self.num_samples = num_samples
        self.seed = seed
        self._configs: List[Dict[str, Any]] = []
        self._i = 0

    def set_search_properties(self, metric, mode, space):
        super().set_search_properties(metric, mode, space)
        self._configs = generate_trial_configs(space, self.num_samples,
                                               seed=self.seed)

    def suggest(self, trial_id: str):
        if self._i >= len(self._configs):
            return None
        cfg = self._configs[self._i]
        self._i += 1
        return cfg


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggestions (reference: search/concurrency_limiter.py):
    model-based searchers degrade when asked for many points with no
    feedback in between."""

    def __init__(self, searcher: Searcher, max_concurrent: int = 2):
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def set_search_properties(self, metric, mode, space):
        super().set_search_properties(metric, mode, space)
        self.searcher.set_search_properties(metric, mode, space)

    def suggest(self, trial_id: str):
        if len(self._live) >= self.max_concurrent:
            return None
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None:
            self._live.add(trial_id)
        return cfg

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result=result, error=error)


class BayesOptSearch(Searcher):
    """Gaussian-process Bayesian optimization with Expected Improvement
    (reference capability: tune/search/bayesopt — there a wrapper around the
    external `bayesian-optimization` package; here self-contained numpy:
    RBF-kernel GP posterior + EI maximized over a random candidate sweep).

    Handles Float (log-aware), Integer and Categorical (one-hot) domains;
    grid_search markers are unsupported (use the basic generator for grids).
    """

    def __init__(self, n_initial: int = 5, candidates: int = 512,
                 length_scale: float = 0.25, noise: float = 1e-6,
                 xi: float = 0.01, seed: int = 0):
        self.n_initial = n_initial
        self.candidates = candidates
        self.length_scale = length_scale
        self.noise = noise
        self.xi = xi
        self.seed = seed
        self._rng = random.Random(seed)
        self._dims: List[tuple] = []  # (path, kind, meta)
        self._x: List[List[float]] = []
        self._y: List[float] = []
        self._pending: Dict[str, List[float]] = {}

    # ---- space encoding: every dim normalized to [0, 1] ------------------
    def set_search_properties(self, metric, mode, space):
        super().set_search_properties(metric, mode, space)
        self._dims = []

        def walk(node, prefix):
            for k, v in node.items():
                path = prefix + (k,)
                if isinstance(v, Float):
                    self._dims.append((path, "float", v))
                elif isinstance(v, Integer):
                    self._dims.append((path, "int", v))
                elif isinstance(v, Categorical):
                    for i, c in enumerate(v.categories):
                        self._dims.append((path, "cat", (v, i)))
                elif _is_grid(v):
                    raise ValueError(
                        "BayesOptSearch does not expand grid_search; use "
                        "BasicVariantGenerator for grids")
                elif isinstance(v, dict):
                    walk(v, path)

        walk(space, ())
        if not self._dims:
            raise ValueError("BayesOptSearch needs at least one Domain")

    def _decode(self, u: List[float]) -> Dict[str, Any]:
        cfg: Dict[str, Any] = {}

        def set_const(node, prefix):
            for k, v in node.items():
                path = prefix + (k,)
                if isinstance(v, dict) and not _is_grid(v):
                    set_const(v, path)
                elif not isinstance(v, Domain):
                    _set_path(cfg, path, v)

        set_const(self.space, ())
        cat_scores: Dict[tuple, List[tuple]] = {}
        for (path, kind, meta), x in zip(self._dims, u):
            if kind == "float":
                d = meta
                if d.log:
                    val = math.exp(
                        math.log(d.low) + x * (math.log(d.high) - math.log(d.low)))
                else:
                    val = d.low + x * (d.high - d.low)
                _set_path(cfg, path, val)
            elif kind == "int":
                d = meta
                _set_path(cfg, path, min(d.high - 1,
                                         d.low + int(x * (d.high - d.low))))
            else:
                dom, idx = meta
                cat_scores.setdefault(path, []).append((x, idx, dom))
        for path, scored in cat_scores.items():
            _, idx, dom = max(scored)
            _set_path(cfg, path, list(dom.categories)[idx])
        return cfg

    # ---- GP posterior ----------------------------------------------------
    def _posterior(self, cand):
        import numpy as np

        x = np.asarray(self._x)      # [n, d]
        y = np.asarray(self._y)
        c = np.asarray(cand)         # [m, d]
        mu_y, sd_y = y.mean(), y.std() + 1e-12
        yn = (y - mu_y) / sd_y

        def rbf(a, b):
            d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
            return np.exp(-0.5 * d2 / self.length_scale ** 2)

        k_xx = rbf(x, x) + self.noise * np.eye(len(x))
        k_xc = rbf(x, c)
        chol = np.linalg.cholesky(k_xx)
        alpha = np.linalg.solve(chol.T, np.linalg.solve(chol, yn))
        mu = k_xc.T @ alpha
        v = np.linalg.solve(chol, k_xc)
        var = np.clip(1.0 - (v ** 2).sum(0), 1e-12, None)
        return mu * sd_y + mu_y, np.sqrt(var) * sd_y

    def suggest(self, trial_id: str):
        d = len(self._dims)
        if len(self._x) < self.n_initial or len(self._x) < 2:
            u = [self._rng.random() for _ in range(d)]
        else:
            import numpy as np
            from math import erf, sqrt

            cand = [[self._rng.random() for _ in range(d)]
                    for _ in range(self.candidates)]
            mu, sigma = self._posterior(cand)
            sign = -1.0 if self.mode == "min" else 1.0
            best = max(sign * yy for yy in self._y)
            z = (sign * mu - best - self.xi) / sigma
            pdf = np.exp(-0.5 * z ** 2) / math.sqrt(2 * math.pi)
            cdf = 0.5 * (1 + np.vectorize(erf)(z / sqrt(2)))
            ei = (sign * mu - best - self.xi) * cdf + sigma * pdf
            u = cand[int(np.argmax(ei))]
        self._pending[trial_id] = u
        return self._decode(u)

    def on_trial_complete(self, trial_id, result=None, error=False):
        u = self._pending.pop(trial_id, None)
        if u is None or error or result is None:
            return
        value = result.get(self.metric)
        if value is None:
            return
        self._x.append(u)
        self._y.append(float(value))
