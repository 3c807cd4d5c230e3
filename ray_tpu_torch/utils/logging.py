"""Logger naming for the port (own copy of ray_tpu.utils.logging.get_logger)."""

from __future__ import annotations

import logging


def get_logger(name: str) -> logging.Logger:
    prefix = "ray_tpu_torch"
    return logging.getLogger(name if name.startswith(prefix) else f"{prefix}.{name}")
