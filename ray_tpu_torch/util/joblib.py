"""joblib backend: ``with joblib.parallel_backend("ray_tpu_torch"): ...``
(own copy of ray_tpu.util.joblib; the backend is registered as
"ray_tpu_torch", the JAX package's as "ray_tpu", so both can be registered
in one process). joblib is imported only when ``register_ray_tpu`` runs.

Reference capability: python/ray/util/joblib/ (register_ray — routes
sklearn/joblib Parallel loops onto the cluster). The backend subclasses
joblib's threading backend but executes each joblib batch as a task, so
n_jobs spans the cluster while joblib keeps its own batching/dispatch
logic.
"""

from __future__ import annotations

from typing import Any

import ray_tpu_torch


def register_ray_tpu() -> None:
    """Register the 'ray_tpu_torch' joblib parallel backend (idempotent)."""
    from joblib import register_parallel_backend
    from joblib._parallel_backends import FallbackToBackend, SequentialBackend, ThreadingBackend

    class RayTpuBackend(ThreadingBackend):
        supports_timeout = True

        def configure(self, n_jobs: int = 1, parallel: Any = None, **kw):
            n_jobs = self.effective_n_jobs(n_jobs)
            if n_jobs == 1:
                raise FallbackToBackend(SequentialBackend(
                    nesting_level=self.nesting_level))
            self.parallel = parallel
            self._n_jobs = n_jobs
            return n_jobs

        def effective_n_jobs(self, n_jobs: int) -> int:
            if n_jobs == 1:
                return 1
            try:
                cpus = int(ray_tpu_torch.cluster_resources().get("CPU", 2))
            except Exception:  # noqa: BLE001
                cpus = 2
            if n_jobs in (None, -1):
                return max(2, cpus)
            return n_jobs

        def apply_async(self, func, callback=None):
            # func is a joblib BatchedCalls: ship the whole batch as ONE task
            @ray_tpu_torch.remote
            def _run_batch(batch):
                return batch()

            ref = _run_batch.remote(func)
            out = _RayFuture(ref)
            if callback is not None:
                # joblib only needs the callback after the result lands;
                # resolve lazily on retrieval is not enough for its dispatch
                # accounting, so collect on a worker thread
                import threading

                def waiter():
                    try:
                        out.get()
                    finally:
                        callback(out)

                threading.Thread(target=waiter, daemon=True).start()
            return out

    class _RayFuture:
        def __init__(self, ref):
            self._ref = ref
            self._value = None
            self._done = False

        def get(self, timeout: Any = None):
            if not self._done:
                self._value = ray_tpu_torch.get(self._ref, timeout=timeout)
                self._done = True
            return self._value

    register_parallel_backend("ray_tpu_torch", RayTpuBackend)
