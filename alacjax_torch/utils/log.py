"""Minimal structured logging (no deps, off by default).

Enable with ALACJAX_LOG=info|debug in the environment.
"""

from __future__ import annotations

import logging
import os
import sys

_CONFIGURED = False


def get_logger(name: str = "alacjax_torch") -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        level_name = os.environ.get("ALACJAX_LOG", "warning").upper()
        level = getattr(logging, level_name, logging.WARNING)
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        root = logging.getLogger("alacjax_torch")
        root.addHandler(handler)
        root.setLevel(level)
        _CONFIGURED = True
    return logging.getLogger(name)
