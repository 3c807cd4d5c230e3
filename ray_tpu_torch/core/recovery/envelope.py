"""Driver-side epoch-aware retry envelope.

The driver has no heartbeat of its own; it observes the GCS incarnation
through the ``gcs_epoch`` now riding ``holder_heartbeat`` acks (the ref
flusher's lease renewal — already periodic, already cheap). The envelope:

- tracks the last-seen epoch and reports bumps, so the runtime can run its
  post-restart catch-up exactly once per incarnation (sealed-channel
  catch-up poll + re-asserting this process's object refs, which may be
  newer than the restored snapshot);
- wraps non-retry-safe control RPCs in park-and-retry: during an outage a
  call sleeps with backoff and re-sends instead of raising, bounded by
  ``recovery_park_timeout_s``. With recovery disabled (RTPU_GCS_RECOVERY=0)
  the wrapper is a plain pass-through call — the fail-fast A/B baseline.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

from ray_tpu_torch.core.config import config, gcs_recovery_enabled
from ray_tpu_torch.core.rpc import RpcConnectionError
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("recovery_envelope")


class RetryEnvelope:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.last_epoch: Optional[int] = None
        self.epoch_bumps = 0

    def observe_epoch(self, epoch: Optional[int]) -> bool:
        """Record an epoch observation; True exactly when it BUMPED (a GCS
        restart happened since the last observation)."""
        if epoch is None:
            return False
        with self._lock:
            bumped = self.last_epoch is not None and epoch != self.last_epoch
            self.last_epoch = epoch
            if bumped:
                self.epoch_bumps += 1
        return bumped

    def send(self, client, method: str, timeout: Any = None, **params) -> Any:
        """``client.call`` (SyncRpcClient) with park-and-retry across a GCS
        outage. Connection loss and per-call timeouts re-send with backoff
        until ``recovery_park_timeout_s``; anything else (an actual remote
        error) raises immediately — the GCS answered, just not happily.

        Named ``send`` (not ``call``) so rtpu-lint's rpc-drift pass sees it
        as a dispatch forwarder rather than shadowing the client method."""
        if not gcs_recovery_enabled():
            if timeout is None:
                return client.call(method, **params)
            return client.call(method, timeout=timeout, **params)
        deadline = time.monotonic() + config.recovery_park_timeout_s
        delay = 0.05
        while True:
            remaining = deadline - time.monotonic()
            try:
                attempt_s = max(0.5, min(10.0, remaining))
                return client.call(method, timeout=attempt_s, **params)
            except (RpcConnectionError, TimeoutError) as e:
                if remaining <= 0:
                    raise RpcConnectionError(
                        f"{method} still failing after parking "
                        f"{config.recovery_park_timeout_s}s for GCS "
                        f"recovery: {e}") from None
                logger.info("parking %s across GCS outage (%.1fs left)",
                            method, remaining)
                time.sleep(min(delay, max(0.0, remaining)))
                delay = min(delay * 2, 1.0)
