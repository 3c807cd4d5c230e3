"""Power-of-two-choices replica router (own copy of
ray_tpu.serve.router).

Reference capability: serve/_private/replica_scheduler/pow_2_scheduler.py
(PowerOfTwoChoicesReplicaScheduler:52, select via queue-length probing
:352). Per-process router: keeps a cached replica set (refreshed from the
controller), picks two random replicas, routes to the one with the shorter
cached queue, and retries on overload/death with the stale replica evicted.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("serve.router")


class Router:
    """Routers subscribe to the controller's versioned config bus
    (reference: serve/long_poll.py LongPollClient): a daemon thread blocks
    in listen_for_change and applies pushed replica-set updates — config
    changes propagate in one RPC latency, with no periodic probing of every
    replica (the old 2 s poll + O(replicas) stats storm)."""

    def __init__(self, controller, app_name: str):
        self._controller = controller
        self._app = app_name
        self._replicas: List[Any] = []
        self._queue_len: Dict[Any, int] = {}  # cached estimates per handle
        self._version = 0
        # sticky multiplex routing: model id -> last replica that served it
        # (locality without control traffic; reference tracks exact
        # model->replica maps over long-poll)
        self._model_affinity: Dict[str, Any] = {}
        self._synced = threading.Event()
        self._stopped = False
        self._lock = threading.Lock()
        self._listener = threading.Thread(
            target=self._listen_loop, daemon=True, name=f"router-poll-{app_name}"
        )
        self._listener.start()

    # ---------------------------------------------------------- replica set
    def stop(self) -> None:
        """Stop the long-poll listener (serve.shutdown path)."""
        self._stopped = True

    def _apply(self, update: Dict[str, Any]) -> None:
        with self._lock:
            self._version = update["version"]
            new = list(update["replicas"])
            # keep queue estimates for survivors; new replicas start at 0
            self._queue_len = {r: self._queue_len.get(r, 0) for r in new}
            self._replicas = new
            # purge pins to replicas no longer in the set (scale-down would
            # otherwise leak dead handles in the affinity map forever)
            live = set(map(id, new))
            for mid in [m for m, r in self._model_affinity.items()
                        if id(r) not in live]:
                del self._model_affinity[mid]
        self._synced.set()

    def _listen_loop(self) -> None:
        backoff = 0.1
        while not self._stopped:
            try:
                update = ray_tpu_torch.get(
                    self._controller.listen_for_change.remote(
                        self._app, self._version, timeout_s=30.0
                    ),
                    timeout=45,
                )
                self._apply(update)
                backoff = 0.1
            except Exception:  # noqa: BLE001 - controller restarting/busy
                if self._stopped:
                    return
                time.sleep(backoff)
                backoff = min(backoff * 2, 2.0)

    def _refresh(self, force: bool = False) -> None:
        """Wait for the first pushed config; after an eviction (``force``)
        wait briefly for a fresh push, but don't stall the retry loop — the
        local eviction already removed the dead replica."""
        if force:
            self._synced.clear()
            self._synced.wait(timeout=0.5)
            self._synced.set()  # never wedge future non-force waits
            return
        self._synced.wait(timeout=10.0)

    def _pick(self, model_id: str = "") -> Any:
        """Pow-2: two random candidates, lower cached queue length wins.
        A multiplexed model id prefers its sticky replica while healthy
        (model stays loaded there), falling back to pow-2 + re-pin."""
        with self._lock:
            replicas = list(self._replicas)
            sticky = self._model_affinity.get(model_id) if model_id else None
        if not replicas:
            raise exc.RayTpuError("no replicas available")
        if sticky is not None and sticky in replicas:
            return sticky
        if len(replicas) == 1:
            choice = replicas[0]
        else:
            a, b = random.sample(replicas, 2)
            with self._lock:
                qa = self._queue_len.get(a, 0)
                qb = self._queue_len.get(b, 0)
            choice = a if qa <= qb else b
        if model_id:
            with self._lock:
                self._model_affinity[model_id] = choice
        return choice

    def _note(self, replica, delta: int) -> None:
        with self._lock:
            if replica in self._queue_len:
                self._queue_len[replica] = max(0, self._queue_len.get(replica, 0) + delta)

    def _unpin(self, model_id: str, replica) -> None:
        """Overloaded sticky replica: drop the pin so the retry re-picks by
        pow-2 (and re-pins wherever it lands)."""
        with self._lock:
            if self._model_affinity.get(model_id) is replica:
                del self._model_affinity[model_id]

    def _evict(self, replica) -> None:
        with self._lock:
            if replica in self._replicas:
                self._replicas.remove(replica)
            self._queue_len.pop(replica, None)
            for mid in [m for m, r in self._model_affinity.items()
                        if r is replica]:
                del self._model_affinity[mid]

    # -------------------------------------------------------------- routing
    def route(self, method: str, args: tuple, kwargs: dict,
              max_attempts: int = 10, multiplexed_model_id: str = "") -> Tuple[Any, Any]:
        """Submit to a chosen replica; returns (result ObjectRef, replica)."""
        self._refresh()
        last: Optional[Exception] = None
        for _ in range(max_attempts):
            try:
                replica = self._pick(multiplexed_model_id)
            except exc.RayTpuError as e:
                last = e
                time.sleep(0.2)
                self._refresh(force=True)
                continue
            self._note(replica, +1)
            ref = replica.handle_request.remote(
                method, args, kwargs,
                multiplexed_model_id=multiplexed_model_id)
            return ref, replica
        raise exc.RayTpuError(f"no route for {self._app}.{method}: {last}")

    def route_streaming(self, method: str, args: tuple, kwargs: dict,
                        max_attempts: int = 10, multiplexed_model_id: str = ""):
        """Submit a streaming request; returns (ObjectRefGenerator, replica).
        Items become available as the replica's generator yields."""
        self._refresh()
        last: Optional[Exception] = None
        for _ in range(max_attempts):
            try:
                replica = self._pick(multiplexed_model_id)
            except exc.RayTpuError as e:
                last = e
                time.sleep(0.2)
                self._refresh(force=True)
                continue
            self._note(replica, +1)
            gen = replica.handle_request_streaming.options(
                num_returns="streaming"
            ).remote(method, args, kwargs,
                     multiplexed_model_id=multiplexed_model_id)
            return gen, replica
        raise exc.RayTpuError(f"no route for {self._app}.{method}: {last}")

    def call_streaming(self, method: str, args: tuple, kwargs: dict,
                       multiplexed_model_id: str = ""):
        """Route AND stream VALUES, retrying overload/replica-death on other
        replicas while no item has been delivered yet (after the first item
        the stream is already partially consumed; mid-stream failures
        propagate)."""
        from ray_tpu_torch.serve.replica import ReplicaOverloadedError

        attempts = 0
        while True:
            gen, replica = self.route_streaming(
                method, args, kwargs,
                multiplexed_model_id=multiplexed_model_id)
            it = iter(gen)
            try:
                try:
                    first_ref = next(it)
                except StopIteration:
                    return
                try:
                    first = ray_tpu_torch.get(first_ref)
                except Exception as e:  # noqa: BLE001
                    retryable = (
                        isinstance(e, ReplicaOverloadedError)
                        or "ReplicaOverloadedError" in type(e).__name__
                        or isinstance(e, (exc.ActorDiedError, exc.ActorUnavailableError))
                    )
                    if retryable:
                        if isinstance(e, (exc.ActorDiedError, exc.ActorUnavailableError)):
                            self._evict(replica)
                            self._refresh(force=True)
                        elif multiplexed_model_id:
                            self._unpin(multiplexed_model_id, replica)
                        attempts += 1
                        if attempts > 20:
                            raise
                        time.sleep(min(0.05 * attempts, 0.5))
                        continue
                    raise
                yield first
                for ref in it:
                    yield ray_tpu_torch.get(ref)
                return
            finally:
                self._note(replica, -1)

    def call(self, method: str, args: tuple, kwargs: dict, timeout: Optional[float] = None,
             multiplexed_model_id: str = ""):
        """Route AND resolve, retrying overloads on other replicas
        (the synchronous fast path used by the proxy)."""
        from ray_tpu_torch.serve.replica import ReplicaOverloadedError

        deadline = None if timeout is None else time.monotonic() + timeout
        attempts = 0
        while True:
            ref, replica = self.route(
                method, args, kwargs,
                multiplexed_model_id=multiplexed_model_id)
            try:
                remaining = None if deadline is None else max(0.1, deadline - time.monotonic())
                result = ray_tpu_torch.get(ref, timeout=remaining)
                self._note(replica, -1)
                return result
            except Exception as e:  # noqa: BLE001
                self._note(replica, -1)
                if isinstance(e, ReplicaOverloadedError) or "ReplicaOverloadedError" in str(type(e).__name__):
                    if multiplexed_model_id:
                        self._unpin(multiplexed_model_id, replica)
                    attempts += 1
                    if attempts > 20:
                        raise
                    time.sleep(min(0.05 * attempts, 0.5))
                    continue
                if isinstance(e, (exc.ActorDiedError, exc.ActorUnavailableError)):
                    self._evict(replica)
                    self._refresh(force=True)
                    attempts += 1
                    if attempts > 5:
                        raise
                    continue
                raise
