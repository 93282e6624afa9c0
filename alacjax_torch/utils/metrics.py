"""The port's span recorder: host-clock spans at the stage boundaries of
the device program (``encode.*``, ``decode.*``) and of the host API
(``api.*``), kept in memory for the caller to read.

Off by default.  ``span(name)`` then returns one shared no-op object, at
the cost of one flag test.  After ``enable()`` each span appends, when it
closes, ``(start_ns, end_ns, name, parent, call_id, thread_id)``:
``time.time_ns()`` readings (the Unix clock, which torch.profiler stamps
its rows with), the index in the list of the span that was open around
it on the same thread (None for an outermost span), the ordinal of the
outermost span it sits in (every span of one call or request shares
it), and the OS thread id.  ``drain()`` returns the list and starts a new
one; call it when no span is open.  Nothing is written anywhere: the
caller decides what to do with the spans.

``readback(tensor, site)`` is the one way the device program reads a
tensor back to the host: ``.tolist()`` inside the span
``f"{site}.sync"``.  Every other blocking host sync of the port's main
paths sits in a span whose name ends in ``.sync``, so the syncs of a
call are its ``*.sync`` spans.

``count(name, n)`` records a count (lanes of a call, say) as
``(name, n, call_id)`` under the call id of the span open around it on
the same thread (None outside every span): one flag test while the
recorder is off.  Counts have their own list, which ``drain_counts()``
returns and starts anew, so the span tuples keep their shape.
"""

from __future__ import annotations

import itertools
import threading
import time

_on = False
_spans: list = []
_counts: list = []
_calls = itertools.count()
_lock = threading.Lock()
_local = threading.local()


class _Off:
    """The span handed out while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "spans", "idx", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
            _local.tid = threading.get_native_id()
        with _lock:
            call = stack[-1][1] if stack else next(_calls)
            self.spans = _spans
            self.idx = len(_spans)
            _spans.append(None)
        stack.append((self.idx, call))
        self.t0 = time.time_ns()
        return None

    def __exit__(self, *exc):
        t1 = time.time_ns()
        stack = _local.stack
        _, call = stack.pop()
        parent = stack[-1][0] if stack else None
        self.spans[self.idx] = (self.t0, t1, self.name, parent, call,
                                _local.tid)
        return False


def span(name: str):
    """A context manager around one stage: recorded while the recorder
    is on, the shared no-op object while it is off."""
    if not _on:
        return _OFF
    return _Span(name)


def count(name: str, n: int) -> None:
    """Record ``n`` under ``name`` for the call whose span is open around
    it, while the recorder is on; nothing while it is off."""
    if not _on:
        return
    stack = getattr(_local, "stack", None)
    call = stack[-1][1] if stack else None
    with _lock:
        _counts.append((name, int(n), call))


def readback(tensor, site: str):
    """``tensor.tolist()`` inside the span ``f"{site}.sync"``: a blocking
    read of a device tensor, counted where it happens."""
    with span(site + ".sync"):
        return tensor.tolist()


def enable() -> None:
    """Record spans from now on (process-wide)."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; spans already recorded stay until ``drain()``."""
    global _on
    _on = False


def drain() -> list:
    """The spans recorded since the last drain, in the order they were
    opened (a parent before its children); the list starts anew."""
    global _spans
    with _lock:
        out, _spans = _spans, []
    return out


def drain_counts() -> list:
    """The counts recorded since the last drain, in the order they were
    recorded; the list starts anew."""
    global _counts
    with _lock:
        out, _counts = _counts, []
    return out
