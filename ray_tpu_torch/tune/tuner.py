"""Tuner: trial generation, execution, scheduling, experiment state (own
copy of ray_tpu.tune.tuner).

Reference capability: python/ray/tune/tuner.py (Tuner.fit:344) +
tune/execution/tune_controller.py (TuneController:68, _step loop:666) +
tune/result_grid.py. The controller is driver-side; each TRIAL is one actor
(``_TrialRunner``) hosting the trainable on a thread with the train-session
report plumbing, so ``ray_tpu_torch.tune.report`` == ``ray_tpu_torch.train.report``.
GpuTrainer.fit routes through a 1-trial Tuner (reference:
train/base_trainer.py:567 — "Trainer.fit IS a Tune run").
"""

from __future__ import annotations

import json
import os
import threading
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.train.session import Checkpoint, TrainContext, _Session
from ray_tpu_torch.train.trainer import Result
from ray_tpu_torch.tune.schedulers import (
    COMPLETE,
    EXPLOIT,
    STOP,
    FIFOScheduler,
    TrialScheduler,
)
from ray_tpu_torch.tune.search import generate_trial_configs
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("tune")


@dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "min"
    num_samples: int = 1
    max_concurrent_trials: int = 4
    scheduler: Optional[TrialScheduler] = None
    # sequential search algorithm (search.Searcher, e.g. BayesOptSearch);
    # None = the grid x random BasicVariant expansion
    search_alg: Optional[Any] = None
    seed: int = 0


@dataclass
class _Trial:
    trial_id: str
    config: Dict[str, Any]
    status: str = "PENDING"  # PENDING RUNNING TERMINATED STOPPED ERROR
    actor: Any = None
    last_result: Dict[str, Any] = field(default_factory=dict)
    history: List[Dict[str, Any]] = field(default_factory=list)
    checkpoint: Optional[str] = None
    iteration: int = 0
    error: Optional[str] = None
    error_obj: Optional[BaseException] = None
    exploit_donor: Optional[str] = None
    restore_from: Optional[str] = None


class _TrialRunner:
    """Actor hosting one trial's trainable on a thread (modeled on
    train/trainer.py TrainWorker)."""

    def __init__(self, trial_id: str, payload: bytes, config: Dict[str, Any],
                 trial_dir: str, restore_from: Optional[str],
                 experiment_name: str, storage_path: str):
        import inspect

        os.makedirs(trial_dir, exist_ok=True)
        trainable = cloudpickle.loads(payload)
        ctx = TrainContext(
            world_rank=0, world_size=1, local_rank=0, local_world_size=1,
            node_rank=0, experiment_name=experiment_name,
            storage_path=storage_path, trial_dir=trial_dir,
        )
        self.session = _Session(
            ctx, Checkpoint(restore_from) if restore_from else None
        )
        session = self.session

        def run() -> None:
            from ray_tpu_torch.train.session import (
                SessionStopped,
                _bind_session_to_current_thread,
                _unbind_current_thread,
            )

            _bind_session_to_current_thread(session)
            try:
                from ray_tpu_torch.train.trainer import GpuTrainer

                if isinstance(trainable, GpuTrainer):
                    trainable.train_loop_config = {
                        **trainable.train_loop_config, **config,
                    }
                    trainable.run_config.name = (
                        f"{experiment_name}_{trial_id}"
                    )
                    trainable.run_config.storage_path = storage_path
                    result = trainable.fit(_tune_session=session,
                                           _resume_from=restore_from)
                    if result.error is not None:
                        session.error = result.error
                elif len(inspect.signature(trainable).parameters) == 0:
                    trainable()
                else:
                    trainable(config)
            except SessionStopped:
                pass  # controller-initiated stop: clean unwind, no error
            except BaseException as e:  # noqa: BLE001
                session.error = e
            finally:
                session.finished = True
                session.result_queue.put({"done": True})
                _unbind_current_thread()

        self.thread = threading.Thread(target=run, daemon=True, name="tune-trial")
        self.thread.start()

    def next_result(self) -> Dict[str, Any]:
        item = self.session.result_queue.get()
        if item.get("done"):
            err = self.session.error
            return {"done": True,
                    "error": cloudpickle.dumps(err) if err is not None else None}
        self.session.continue_event.set()
        return item

    def stop(self) -> bool:
        """Request a cooperative stop: the trainable thread raises
        SessionStopped at its next report(), unwinding through user code so
        nested resources (TrainWorker gangs, placement groups) are released."""
        self.session.stop_requested = True
        self.session.continue_event.set()
        return True

    def join(self, timeout: float = 30.0) -> bool:
        self.thread.join(timeout)
        return not self.thread.is_alive()


class ResultGrid:
    def __init__(self, results: List[Result], trials: List[_Trial]):
        self._results = results
        self._trials = trials

    def __len__(self) -> int:
        return len(self._results)

    def __getitem__(self, i: int) -> Result:
        return self._results[i]

    @property
    def errors(self) -> List[BaseException]:
        return [r.error for r in self._results if r.error is not None]

    def get_best_result(self, metric: str, mode: str = "min") -> Result:
        scored = [r for r in self._results if metric in r.metrics]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        key = lambda r: r.metrics[metric]  # noqa: E731
        return min(scored, key=key) if mode == "min" else max(scored, key=key)

    def get_dataframe(self):
        rows = [
            {"trial_id": t.trial_id, **{f"config/{k}": v for k, v in t.config.items()
                                        if not isinstance(v, dict)},
             **t.last_result}
            for t in self._trials
        ]
        try:
            import pandas as pd

            return pd.DataFrame(rows)
        except ImportError:
            return rows


class Tuner:
    def __init__(self, trainable: Any, *, param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 _restore_path: Optional[str] = None):
        self._trainable = trainable
        self._param_space = param_space or {}
        self._tune_config = tune_config or TuneConfig()
        self._run_config = run_config or RunConfig()
        if self._run_config.name is None:
            self._run_config.name = f"tune_{uuid.uuid4().hex[:8]}"
        self._restore_path = _restore_path

    # ------------------------------------------------------------ experiment
    @property
    def _exp_dir(self) -> str:
        return self._run_config.resolved_storage_path()

    def _save_state(self, trials: List[_Trial]) -> None:
        state = {
            "name": self._run_config.name,
            "trials": [
                {"trial_id": t.trial_id, "config": t.config, "status": t.status,
                 "last_result": t.last_result, "checkpoint": t.checkpoint,
                 "iteration": t.iteration, "error": t.error}
                for t in trials
            ],
        }
        os.makedirs(self._exp_dir, exist_ok=True)
        tmp = os.path.join(self._exp_dir, ".experiment_state.tmp")
        with open(tmp, "w") as f:
            json.dump(state, f, indent=1, default=str)
        os.replace(tmp, os.path.join(self._exp_dir, "experiment_state.json"))

    @classmethod
    def restore(cls, path: str, trainable: Any,
                tune_config: Optional[TuneConfig] = None) -> "Tuner":
        """Resume an interrupted experiment: finished trials keep their
        results; unfinished ones restart (from their last checkpoint if
        they reported one)."""
        run_config = RunConfig(name=os.path.basename(path.rstrip("/")),
                               storage_path=os.path.dirname(path.rstrip("/")))
        return cls(trainable, tune_config=tune_config, run_config=run_config,
                   _restore_path=path)

    # ------------------------------------------------------------------- fit
    def fit(self) -> ResultGrid:
        cfg = self._tune_config
        scheduler = cfg.scheduler or FIFOScheduler()
        searcher = cfg.search_alg
        trials = self._build_trials()
        payload = cloudpickle.dumps(self._trainable)
        exp_name = self._run_config.name
        storage = self._exp_dir
        os.makedirs(storage, exist_ok=True)

        pending = [t for t in trials if t.status == "PENDING"]
        running: Dict[str, Any] = {}  # trial_id -> in-flight next_result ref
        by_ref: Dict[Any, _Trial] = {}
        created = len(trials)
        if searcher is not None:
            searcher.set_search_properties(cfg.metric or "loss", cfg.mode,
                                           self._param_space or {})

        def searcher_done(trial: _Trial) -> None:
            if searcher is not None:
                searcher.on_trial_complete(
                    trial.trial_id, result=trial.last_result or None,
                    error=trial.status == "ERROR")

        def top_up() -> None:
            nonlocal created
            while (searcher is not None and created < cfg.num_samples
                   and len(pending) + len(running) < cfg.max_concurrent_trials):
                tid = f"trial_{created:05d}"
                config = searcher.suggest(tid)
                if config is None:
                    return  # withheld (concurrency limit) or exhausted
                t = _Trial(trial_id=tid, config=config)
                trials.append(t)
                pending.append(t)
                created += 1

        def launch(trial: _Trial) -> None:
            trial_dir = os.path.join(storage, trial.trial_id)
            trial.actor = ray_tpu_torch.remote(_TrialRunner).options(
                max_concurrency=2
            ).remote(
                trial.trial_id, payload, trial.config, trial_dir,
                trial.restore_from, exp_name, storage,
            )
            trial.status = "RUNNING"
            ref = trial.actor.next_result.remote()
            running[trial.trial_id] = ref
            by_ref[ref] = trial

        while (pending or running
               or (searcher is not None and created < cfg.num_samples)):
            top_up()
            while pending and len(running) < cfg.max_concurrent_trials:
                launch(pending.pop(0))
            if not running and not pending:
                break  # searcher exhausted with nothing in flight
            ready, _ = ray_tpu_torch.wait(list(running.values()), num_returns=1,
                                    timeout=300.0)
            if not ready:
                continue
            ref = ready[0]
            trial = by_ref.pop(ref)
            del running[trial.trial_id]
            try:
                item = ray_tpu_torch.get(ref, timeout=60)
            except Exception as e:  # noqa: BLE001 - actor death = trial error
                self._finish_trial(trial, error=e, scheduler=scheduler)
                searcher_done(trial)
                self._save_state(trials)
                continue
            if item.get("done"):
                err = cloudpickle.loads(item["error"]) if item.get("error") else None
                self._finish_trial(trial, error=err, scheduler=scheduler)
                searcher_done(trial)
                self._save_state(trials)
                continue
            metrics = dict(item.get("metrics") or {})
            trial.iteration += 1
            trial.last_result = metrics
            trial.history.append(metrics)
            if item.get("checkpoint"):
                trial.checkpoint = item["checkpoint"]
            # schedulers see training_iteration; the user's reported metrics
            # dict (and thus Result.metrics) is NOT mutated — fit()'s return
            # contract predates the Tune routing
            sched_result = {"training_iteration": trial.iteration, **metrics}
            decision = scheduler.on_result(trial, sched_result)
            if decision in (STOP, COMPLETE):
                trial.status = "STOPPED" if decision == STOP else "TERMINATED"
                self._stop_actor(trial)
                scheduler.on_complete(trial)
                searcher_done(trial)
            elif decision == EXPLOIT:
                self._exploit(trial, trials, scheduler, pending)
            else:
                ref = trial.actor.next_result.remote()
                running[trial.trial_id] = ref
                by_ref[ref] = trial
            self._save_state(trials)

        results = [self._to_result(t) for t in trials]
        return ResultGrid(results, trials)

    # ------------------------------------------------------------------ utils
    def _build_trials(self) -> List[_Trial]:
        cfg = self._tune_config
        prior: Dict[str, Dict[str, Any]] = {}
        if self._restore_path:
            state_file = os.path.join(self._restore_path, "experiment_state.json")
            if os.path.exists(state_file):
                with open(state_file) as f:
                    prior = {t["trial_id"]: t for t in json.load(f)["trials"]}
        if prior:
            trials = []
            for tid, rec in prior.items():
                t = _Trial(trial_id=tid, config=rec["config"],
                           last_result=rec.get("last_result") or {},
                           checkpoint=rec.get("checkpoint"),
                           iteration=rec.get("iteration", 0))
                if rec["status"] in ("TERMINATED", "STOPPED"):
                    t.status = rec["status"]
                else:
                    t.status = "PENDING"
                    t.restore_from = rec.get("checkpoint")
                trials.append(t)
            return trials
        if cfg.search_alg is not None:
            return []  # trials come from the searcher, one suggest at a time
        configs = generate_trial_configs(self._param_space, cfg.num_samples,
                                         seed=cfg.seed)
        return [
            _Trial(trial_id=f"trial_{i:05d}", config=c)
            for i, c in enumerate(configs)
        ]

    def _exploit(self, trial: _Trial, trials: List[_Trial],
                 scheduler: TrialScheduler, pending: List[_Trial]) -> None:
        """PBT: stop this trial; relaunch from the donor's checkpoint with a
        mutated copy of the donor's config."""
        donor = next((t for t in trials if t.trial_id == trial.exploit_donor), None)
        self._stop_actor(trial)
        if donor is None or donor.checkpoint is None:
            # nothing to exploit yet: just continue the trial as-is
            trial.status = "PENDING"
            trial.restore_from = trial.checkpoint
            pending.append(trial)
            return
        explore = getattr(scheduler, "explore", None)
        new_config = explore(donor.config) if explore else dict(donor.config)
        logger.info("PBT exploit: %s <- %s (config %s)", trial.trial_id,
                    donor.trial_id, new_config)
        trial.config = new_config
        trial.restore_from = donor.checkpoint
        trial.status = "PENDING"
        pending.append(trial)

    def _stop_actor(self, trial: _Trial) -> None:
        if trial.actor is None:
            return
        try:
            ray_tpu_torch.get(trial.actor.stop.remote(), timeout=10)
            ray_tpu_torch.get(trial.actor.join.remote(), timeout=60)
        except Exception:  # noqa: BLE001 - best effort; fall through to kill
            pass
        try:
            ray_tpu_torch.kill(trial.actor)
        except Exception:  # noqa: BLE001
            pass
        trial.actor = None

    def _finish_trial(self, trial: _Trial, error: Optional[BaseException],
                      scheduler: TrialScheduler) -> None:
        trial.status = "ERROR" if error is not None else "TERMINATED"
        trial.error = repr(error) if error is not None else None
        trial.error_obj = error
        if error is not None:
            logger.warning("trial %s failed: %s", trial.trial_id, error)
        self._stop_actor(trial)
        scheduler.on_complete(trial)

    def _to_result(self, trial: _Trial) -> Result:
        # prefer the ORIGINAL exception object (callers isinstance-check it);
        # the repr string only stands in after a restore from disk
        error = trial.error_obj
        if error is None and trial.error:
            error = RuntimeError(trial.error)
        return Result(
            metrics=trial.last_result,
            checkpoint=Checkpoint(trial.checkpoint) if trial.checkpoint else None,
            error=error,
            metrics_history=trial.history,
        )
