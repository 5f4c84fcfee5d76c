"""Logging with HOROVOD_LOG_LEVEL control (the port's copy of
``horovod_tpu/utils/logging.py``)."""

from __future__ import annotations

import logging
import sys

from horovod_tpu_torch.config import knobs

_LEVELS = {
    "trace": logging.DEBUG - 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

_configured = False


def get_logger(name: str = "horovod_tpu_torch") -> logging.Logger:
    global _configured
    logger = logging.getLogger(name)
    if not _configured:
        level = _LEVELS.get(str(knobs.get("HOROVOD_LOG_LEVEL")).lower(),
                            logging.WARNING)
        handler = logging.StreamHandler(sys.stderr)
        if knobs.get("HOROVOD_LOG_HIDE_TIMESTAMP"):
            fmt = "[%(levelname)s] %(name)s: %(message)s"
        else:
            fmt = "%(asctime)s [%(levelname)s] %(name)s: %(message)s"
        handler.setFormatter(logging.Formatter(fmt))
        root = logging.getLogger("horovod_tpu_torch")
        root.addHandler(handler)
        root.setLevel(level)
        root.propagate = False
        _configured = True
    return logger
