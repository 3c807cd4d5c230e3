"""Trial schedulers: FIFO, ASHA, PBT (own copy of ray_tpu.tune.schedulers).

Reference capability: python/ray/tune/schedulers/ (trial_scheduler.py
decision enum, async_hyperband.py ASHAScheduler rung/bracket logic,
pbt.py PopulationBasedTraining exploit/explore)."""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, TYPE_CHECKING

if TYPE_CHECKING:
    from ray_tpu_torch.tune.tuner import _Trial

CONTINUE = "CONTINUE"
STOP = "STOP"  # early-stop: the trial lost its rung
COMPLETE = "COMPLETE"  # budget exhausted (max_t): a normal completion
# PBT: restart this trial from a donor's checkpoint with a mutated config
EXPLOIT = "EXPLOIT"


class TrialScheduler:
    def on_result(self, trial: "_Trial", result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_complete(self, trial: "_Trial") -> None:
        pass


class FIFOScheduler(TrialScheduler):
    """Run every trial to completion."""


class ASHAScheduler(TrialScheduler):
    """Asynchronous Successive Halving (reference:
    tune/schedulers/async_hyperband.py AsyncHyperBandScheduler/_Bracket).

    Rungs at grace_period * reduction_factor^k. When a trial reaches a rung,
    it continues only if its metric is in the top 1/reduction_factor of all
    values RECORDED at that rung so far (async: no waiting for stragglers).
    """

    def __init__(self, metric: str = "loss", mode: str = "min",
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, reduction_factor: int = 4,
                 max_t: int = 100):
        assert mode in ("min", "max")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace = max(1, grace_period)
        self.rf = max(2, reduction_factor)
        self.max_t = max_t
        # rung milestone -> recorded metric values
        self.rungs: Dict[int, List[float]] = {}
        # trial_id -> set of milestones already recorded (rungs are crossed
        # with >=, not ==: trainables rarely report at exact milestone steps)
        self._crossed: Dict[str, set] = {}
        milestones = []
        t = self.grace
        while t < max_t:
            milestones.append(t)
            t *= self.rf
        self.milestones = milestones

    def on_result(self, trial: "_Trial", result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr)
        value = result.get(self.metric)
        if t is None or value is None:
            return CONTINUE
        if t >= self.max_t:
            return COMPLETE
        decision = CONTINUE
        crossed = self._crossed.setdefault(trial.trial_id, set())
        for milestone in self.milestones:
            if t >= milestone and milestone not in crossed:
                crossed.add(milestone)
                recorded = self.rungs.setdefault(milestone, [])
                recorded.append(float(value))
                if not self._in_top_fraction(float(value), recorded):
                    decision = STOP
        return decision

    def _in_top_fraction(self, value: float, recorded: List[float]) -> bool:
        if len(recorded) < self.rf:
            return True  # too few to cut (async optimism, matches reference)
        ordered = sorted(recorded, reverse=(self.mode == "max"))
        k = max(1, len(ordered) // self.rf)
        cutoff = ordered[k - 1]
        return value <= cutoff if self.mode == "min" else value >= cutoff


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: tune/schedulers/pbt.py): at each
    perturbation_interval, bottom-quantile trials EXPLOIT a top-quantile
    donor (restore its checkpoint) and EXPLORE a mutated config."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25, seed: int = 0):
        assert mode in ("min", "max")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.interval = max(1, perturbation_interval)
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.rng = random.Random(seed)
        # trial_id -> (last_perturb_t, latest metric)
        self.last_perturb: Dict[str, int] = {}
        self.scores: Dict[str, float] = {}

    def on_result(self, trial: "_Trial", result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr)
        value = result.get(self.metric)
        if t is None or value is None:
            return CONTINUE
        self.scores[trial.trial_id] = float(value)
        last = self.last_perturb.get(trial.trial_id, 0)
        if t - last < self.interval:
            return CONTINUE
        self.last_perturb[trial.trial_id] = t
        ranked = sorted(
            self.scores.items(), key=lambda kv: kv[1],
            reverse=(self.mode == "max"),
        )
        n = len(ranked)
        if n < 2:
            return CONTINUE
        k = max(1, int(math.ceil(n * self.quantile)))
        bottom_ids = {tid for tid, _ in ranked[-k:]}
        top_ids = [tid for tid, _ in ranked[:k]]
        if trial.trial_id in bottom_ids and trial.trial_id not in top_ids:
            trial.exploit_donor = self.rng.choice(top_ids)
            return EXPLOIT
        return CONTINUE

    def explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        """Mutate a donor's config (reference: pbt.py explore — x0.8/x1.2 or
        resample from the mutation space)."""
        from ray_tpu_torch.tune.search import Domain

        out = dict(config)
        for key, spec in self.mutations.items():
            cur = out.get(key)
            if isinstance(spec, Domain):
                if self.rng.random() < 0.25 or cur is None or not isinstance(cur, (int, float)):
                    out[key] = spec.sample(self.rng)
                else:
                    out[key] = cur * self.rng.choice([0.8, 1.2])
            elif isinstance(spec, (list, tuple)):
                out[key] = self.rng.choice(list(spec))
            elif callable(spec):
                out[key] = spec()
        return out

    def on_complete(self, trial: "_Trial") -> None:
        self.scores.pop(trial.trial_id, None)


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose best result so far is worse than the median of the
    other trials' running averages at the same time step (reference:
    tune/schedulers/median_stopping_rule.py)."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        assert mode in ("min", "max")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        # trial_id -> list of metric values (one per report)
        self.histories: Dict[str, List[float]] = {}

    def on_result(self, trial: "_Trial", result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr)
        value = result.get(self.metric)
        if t is None or value is None:
            return CONTINUE
        hist = self.histories.setdefault(trial.trial_id, [])
        hist.append(float(value))
        if t <= self.grace_period:
            return CONTINUE
        others = [h for tid, h in self.histories.items()
                  if tid != trial.trial_id and len(h) >= len(hist)]
        if len(others) < self.min_samples:
            return CONTINUE
        # running average of each other trial up to this step
        avgs = sorted(sum(h[: len(hist)]) / len(hist) for h in others)
        median = avgs[len(avgs) // 2]
        best = min(hist) if self.mode == "min" else max(hist)
        worse = best > median if self.mode == "min" else best < median
        return STOP if worse else CONTINUE

    def on_complete(self, trial: "_Trial") -> None:
        # histories stay: completed trials keep informing the median
        pass
