"""Utilities: the span recorder (``metrics``: ``span``, ``readback``,
``enable``, ``disable``, ``drain``) and a dependency-free logger."""

from .log import get_logger
from .metrics import disable, drain, enable, readback, span

__all__ = ["span", "readback", "enable", "disable", "drain", "get_logger"]
