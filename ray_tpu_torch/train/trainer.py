"""GpuTrainer: distributed training orchestration over the actor runtime
(the counterpart of ``ray_tpu.train.trainer.TpuTrainer``).

Reference capability: python/ray/train/data_parallel_trainer.py +
_internal/backend_executor.py (BackendExecutor.start:135 placement group +
WorkerGroup, rank assignment :369, start_training:451, lockstep result
collection get_next_results:578, restart-from-checkpoint loop :759) — with
torch.distributed where the JAX package calls ``jax.distributed``:

- each worker is one gang member holding ``gpus_per_worker`` cards; with
  ``use_torch_distributed`` worker 0's address seeds
  ``torch.distributed.init_process_group`` (NCCL on a worker that holds a
  GPU, gloo otherwise), so the gang forms one process group;
- placement uses a PACK placement group over per-worker bundles;
- ``FailureConfig(max_failures)``: on any worker failure the whole group is
  torn down and restarted from the latest checkpoint (restart-based
  elasticity, matching the reference's semantics).

On the cluster runtime every ``TrainWorker`` is its own worker process
(on a GPU worker it sees its cards only), so ``use_torch_distributed`` with
``num_workers > 1`` forms one process group across the gang. In the
in-process runtime every worker is a thread of one process, so a process
group spans one worker at most: there ``use_torch_distributed`` with more
than one worker raises before any worker starts.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.session import Checkpoint, TrainContext, _Session
from ray_tpu_torch.util.placement_group import placement_group, remove_placement_group
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("train")


@dataclass
class Result:
    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    error: Optional[BaseException] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def best_checkpoint(self) -> Optional[Checkpoint]:
        return self.checkpoint


@ray_tpu_torch.remote
class TrainWorker:
    """One gang member; hosts the user training thread + session."""

    def __init__(self, rank: int, world_size: int, ctx_kwargs: Dict[str, Any]):
        self.rank = rank
        self.world_size = world_size
        self.ctx_kwargs = ctx_kwargs
        self.session = None
        self.thread = None
        self.owns_group = False

    def get_address(self) -> str:
        """Worker 0 provides the process group's rendezvous address: this
        host and a port that was free when asked."""
        import socket

        hostname = socket.gethostname()
        try:
            ip = socket.gethostbyname(hostname)
        except OSError:
            ip = "127.0.0.1"
        with socket.socket() as s:
            s.bind((ip, 0))
            port = s.getsockname()[1]
        return f"{ip}:{port}"

    def setup_torch_distributed(self, coordinator: str, use_distributed: bool,
                                holds_gpu: bool) -> bool:
        """Form one process group across the gang from worker 0's address
        (where the JAX package calls ``jax.distributed.initialize``)."""
        if use_distributed:
            import torch.distributed as dist

            dist.init_process_group(
                "nccl" if holds_gpu else "gloo", init_method=f"tcp://{coordinator}",
                world_size=self.world_size, rank=self.rank)
            self.owns_group = True
        return True

    def start_training(self, fn_payload: bytes, train_config: Dict[str, Any],
                       latest_checkpoint: Optional[str],
                       dataset_shards: Optional[bytes] = None) -> bool:
        import threading

        fn = cloudpickle.loads(fn_payload)
        ctx = TrainContext(
            world_rank=self.rank,
            world_size=self.world_size,
            local_rank=0,
            local_world_size=1,
            node_rank=self.rank,
            **self.ctx_kwargs,
        )
        shards = cloudpickle.loads(dataset_shards) if dataset_shards else {}
        self.session = _Session(
            ctx, Checkpoint(latest_checkpoint) if latest_checkpoint else None,
            dataset_shards=shards,
        )
        session = self.session

        def run() -> None:
            from ray_tpu_torch.train.session import _bind_session_to_current_thread, _unbind_current_thread
            import inspect

            _bind_session_to_current_thread(session)
            try:
                sig = inspect.signature(fn)
                if len(sig.parameters) == 0:
                    fn()
                else:
                    fn(train_config)
            except BaseException as e:  # noqa: BLE001
                session.error = e
            finally:
                session.finished = True
                session.result_queue.put({"done": True})
                _unbind_current_thread()

        self.thread = threading.Thread(target=run, daemon=True, name="train-fn")
        self.thread.start()
        return True

    def next_result(self) -> Dict[str, Any]:
        """Blocks until the user fn reports or finishes."""
        item = self.session.result_queue.get()
        if item.get("done"):
            err = self.session.error
            return {
                "done": True,
                "error": cloudpickle.dumps(err) if err is not None else None,
            }
        self.session.continue_event.set()
        return item

    def shutdown(self) -> bool:
        """Destroy the process group this worker created, if any."""
        if self.owns_group:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
            self.owns_group = False
        return True


def _runtime_is_in_process() -> bool:
    from ray_tpu_torch.core.worker import global_worker

    w = global_worker()
    return w is None or w.runtime.is_local


class GpuTrainer:
    """North-star API: GpuTrainer(fn, scaling_config=...).fit()
    (reference: DataParallelTrainer / TorchTrainer; counterpart of
    ``ray_tpu.train.trainer.TpuTrainer``)."""

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        use_torch_distributed: bool = False,
    ):
        self.train_loop = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.scaling = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.use_torch_distributed = use_torch_distributed

    def fit(self, _tune_session=None, _resume_from: Optional[str] = None) -> Result:
        """Run the distributed training job.

        Routed through Tune when called without a session (reference:
        train/base_trainer.py:567 — ``Trainer.fit`` IS a 1-trial Tune run, so
        failure handling, experiment state, and result plumbing are shared
        with hyperparameter sweeps). The Tuner's trial actor calls back in
        with ``_tune_session`` set, which runs the gang directly and streams
        per-round metrics to the trial."""
        if (self.use_torch_distributed and self.scaling.num_workers > 1
                and _runtime_is_in_process()):
            raise ValueError(
                f"use_torch_distributed=True with num_workers={self.scaling.num_workers}: "
                "the in-process runtime runs every worker in this process, and one "
                "process holds one default process group; use num_workers=1, or "
                "connect to a cluster (ray_tpu_torch.cluster), whose workers are "
                "processes of their own")
        if _tune_session is None:
            from ray_tpu_torch.tune.tuner import TuneConfig, Tuner

            tuner = Tuner(
                self,
                tune_config=TuneConfig(num_samples=1, max_concurrent_trials=1),
                run_config=self.run_config,
            )
            grid = tuner.fit()
            return grid[0]
        max_failures = self.run_config.failure_config.max_failures
        trial_dir = self.run_config.resolved_storage_path()
        os.makedirs(trial_dir, exist_ok=True)
        latest_checkpoint: Optional[str] = _resume_from
        history: List[Dict[str, Any]] = []
        failures = 0
        while True:
            try:
                result = self._run_attempt(trial_dir, latest_checkpoint, history,
                                           tune_session=_tune_session)
                return result
            except _AttemptFailed as e:
                failures += 1
                latest_checkpoint = e.latest_checkpoint or latest_checkpoint
                if max_failures >= 0 and failures > max_failures:
                    return Result(
                        metrics=history[-1] if history else {},
                        checkpoint=Checkpoint(latest_checkpoint) if latest_checkpoint else None,
                        error=e.error,
                        metrics_history=history,
                    )
                logger.warning(
                    "training attempt failed (%s); restarting from %s (failure %d/%d)",
                    e.error, latest_checkpoint, failures, max_failures,
                )

    # ------------------------------------------------------------------
    def _run_attempt(self, trial_dir: str, latest_checkpoint: Optional[str],
                     history: List[Dict[str, Any]], tune_session=None) -> Result:
        scaling = self.scaling
        pg = None
        workers: List[Any] = []
        try:
            pg = placement_group(scaling.bundles(), strategy=scaling.placement_strategy)
            pg.ready(timeout=60)
            ctx_kwargs = {
                "experiment_name": self.run_config.name or "train_run",
                "storage_path": self.run_config.resolved_storage_path(),
                "trial_dir": trial_dir,
            }
            for rank in range(scaling.num_workers):
                res = scaling.worker_resources()
                workers.append(
                    TrainWorker.options(
                        num_cpus=res.get("CPU", 0),
                        num_gpus=res.get("GPU", 0),
                        resources={k: v for k, v in res.items() if k not in ("CPU", "GPU")},
                        placement_group=pg,
                        placement_group_bundle_index=rank,
                    ).remote(rank, scaling.num_workers, ctx_kwargs)
                )
            # rendezvous: worker 0 coordinates (the gang's process group)
            coordinator = ray_tpu_torch.get(workers[0].get_address.remote(), timeout=120)
            holds_gpu = bool(scaling.worker_resources().get("GPU"))
            ray_tpu_torch.get(
                [w.setup_torch_distributed.remote(coordinator, self.use_torch_distributed,
                                                  holds_gpu) for w in workers],
                timeout=300,
            )
            payload = cloudpickle.dumps(self.train_loop)
            # per-worker dataset shards via streaming_split (reference:
            # DataConfig.configure + ray.train.get_dataset_shard)
            shard_table: List[Dict[str, Any]] = [{} for _ in range(scaling.num_workers)]
            for ds_name, ds in self.datasets.items():
                for rank, shard in enumerate(ds.streaming_split(scaling.num_workers)):
                    shard_table[rank][ds_name] = shard
            ray_tpu_torch.get(
                [
                    w.start_training.remote(
                        payload, self.train_loop_config, latest_checkpoint,
                        cloudpickle.dumps(shard_table[rank]),
                    )
                    for rank, w in enumerate(workers)
                ],
                timeout=120,
            )
            final_error: Optional[BaseException] = None
            done = False
            while not done:
                try:
                    round_results = ray_tpu_torch.get(
                        [w.next_result.remote() for w in workers], timeout=3600
                    )
                except (exc.ActorDiedError, exc.ActorUnavailableError, exc.GetTimeoutError) as e:
                    raise _AttemptFailed(e, latest_checkpoint) from e
                if any(r.get("done") for r in round_results):
                    done = True
                    for r in round_results:
                        if r.get("error"):
                            final_error = cloudpickle.loads(r["error"])
                    break
                rank0 = round_results[0]
                history.append(rank0["metrics"])
                ckpts = [r.get("checkpoint") for r in round_results]
                if ckpts and ckpts[0]:
                    latest_checkpoint = ckpts[0]  # rank 0's checkpoint wins
                elif any(ckpts):
                    latest_checkpoint = next(c for c in ckpts if c)
                self._apply_keep_policy(trial_dir)
                if tune_session is not None:
                    # stream the round to the owning Tune trial (lockstep,
                    # same contract as session.report)
                    tune_session.result_queue.put({
                        "metrics": dict(rank0["metrics"]),
                        "checkpoint": latest_checkpoint,
                        "done": False,
                    })
                    tune_session.continue_event.wait()
                    tune_session.continue_event.clear()
                    if tune_session.stop_requested:
                        from ray_tpu_torch.train.session import SessionStopped

                        # unwind through _run_attempt's finally: gang +
                        # placement group released before the trial stops
                        raise SessionStopped()
            if final_error is not None:
                raise _AttemptFailed(final_error, latest_checkpoint)
            return Result(
                metrics=history[-1] if history else {},
                checkpoint=Checkpoint(latest_checkpoint) if latest_checkpoint else None,
                error=None,
                metrics_history=history,
            )
        finally:
            # every worker at once: destroying a process group can wait for
            # its peers to destroy theirs
            try:
                ray_tpu_torch.get([w.shutdown.remote() for w in workers], timeout=10)
            except Exception:  # noqa: BLE001 - best effort; the kill follows
                pass
            for w in workers:
                try:
                    ray_tpu_torch.kill(w)
                except Exception:  # noqa: BLE001
                    pass
            if pg is not None:
                try:
                    remove_placement_group(pg)
                except Exception:  # noqa: BLE001
                    pass

    def _apply_keep_policy(self, trial_dir: str) -> None:
        keep = self.run_config.checkpoint_config.num_to_keep
        if not keep:
            return
        import shutil

        # Dirs are checkpoint_<step>_rank<r>: group per STEP so num_to_keep
        # counts checkpoints, not per-rank shards (W ranks would otherwise
        # shrink the window to num_to_keep/W steps).
        groups: Dict[str, List[str]] = {}
        for entry in os.listdir(trial_dir):
            if not entry.startswith("checkpoint_"):
                continue
            step_key = entry.split("_rank")[0]
            groups.setdefault(step_key, []).append(entry)
        ordered = sorted(
            groups,
            key=lambda s: max(os.path.getmtime(os.path.join(trial_dir, e))
                              for e in groups[s]),
        )
        for stale_step in ordered[:-keep]:
            for entry in groups[stale_step]:
                shutil.rmtree(os.path.join(trial_dir, entry), ignore_errors=True)


class _AttemptFailed(Exception):
    def __init__(self, error: BaseException, latest_checkpoint: Optional[str]):
        self.error = error
        self.latest_checkpoint = latest_checkpoint
        super().__init__(str(error))
