"""Structured logging: one stdlib logger hierarchy under ``uslam`` (the JAX
package's ``uslam_tpu.utils.logging``). Set the environment variable
``USLAM_LOG=DEBUG`` to raise verbosity."""

from __future__ import annotations

import logging
import os
import sys

_CONFIGURED = False


def _configure() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    root = logging.getLogger("uslam")
    level = os.environ.get("USLAM_LOG", "INFO").upper()
    root.setLevel(getattr(logging, level, logging.INFO))
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s", "%H:%M:%S")
    )
    root.addHandler(handler)
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    _configure()
    return logging.getLogger(f"uslam.{name}")
