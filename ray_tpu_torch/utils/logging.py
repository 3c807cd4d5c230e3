"""Structured logging setup (own copy of ray_tpu.utils.logging; reference
capability: src/ray/util/logging.h + python/ray/_private/ray_logging/ —
per-component log files under a session dir, env-tunable level, optional
JSON lines)."""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional

_FORMAT = "%(asctime)s %(levelname)s %(name)s:%(lineno)d -- %(message)s"


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        data = {
            "ts": time.time(),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
            "pid": os.getpid(),
        }
        if record.exc_info:
            data["exc"] = self.formatException(record.exc_info)
        for key in ("node_id", "worker_id", "task_id", "actor_id", "component"):
            val = getattr(record, key, None)
            if val is not None:
                data[key] = val
        return json.dumps(data)


def get_logger(name: str) -> logging.Logger:
    prefix = "ray_tpu_torch"
    return logging.getLogger(name if name.startswith(prefix) else f"{prefix}.{name}")


def setup_component_logging(
    component: str,
    session_dir: Optional[str] = None,
    level: Optional[str] = None,
    json_lines: bool = False,
    also_stderr: bool = True,
) -> logging.Logger:
    """Configure the ray_tpu_torch root logger for one process/component.

    Writes to ``<session_dir>/logs/<component>.pid<pid>.log`` when a session
    dir is given (the log-monitor tails this directory)."""
    root = logging.getLogger("ray_tpu_torch")
    root.setLevel((level or os.environ.get("RAY_TPU_LOG_LEVEL", "INFO")).upper())
    for h in list(root.handlers):
        root.removeHandler(h)
    formatter = JsonFormatter() if json_lines else logging.Formatter(_FORMAT)
    if session_dir:
        log_dir = os.path.join(session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, f"{component}.pid{os.getpid()}.log"))
        fh.setFormatter(formatter)
        root.addHandler(fh)
    if also_stderr:
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(formatter)
        root.addHandler(sh)
    root.propagate = False
    # `kill -USR1 <pid>` dumps every thread's stack to stderr (which the
    # supervisor redirects into the session log) — the `ray stack` analogue
    # (reference: scripts `ray stack` / python/ray/util/rpdb.py)
    try:
        import faulthandler
        import signal

        faulthandler.register(signal.SIGUSR1, all_threads=True, chain=True)
    except (ImportError, ValueError, AttributeError):
        pass  # non-main thread / unsupported platform
    return root
