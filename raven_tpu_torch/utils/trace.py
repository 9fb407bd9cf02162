"""The port's spans: where the host is, on the device trace's clock.

`span(name, **counts)` marks one step of the program.  It is live only
while a torch profiler records (the profiler's own enabled flag, ~0.1 us to
read): then it opens the profiler range "raven:<name>" and, at its end,
appends a record to this module's log (`spans()`, emptied by `clear()`).
With no profiler recording it opens no range and logs nothing, so an
operator gets the spans by running the program under `torch.profiler`, and
no switch exists.

A record holds the name, an id, its parent's id, the id of the outermost
span open on its thread (the one a pass or call hangs from), its start and
end in Unix-epoch nanoseconds (`time.time_ns()`, the clock the profiler's
events are reported on, so records compare directly with a trace's device
events), and its counts: ints, and the polish round's engine.  The body adds
counts by item (`s["rows"] = n`).

A span given `log` is also a stage-log line: at its end, unless the body
raised, it prints "<log> <seconds>s" to stderr, the seconds on the host's
monotonic clock whether or not a profiler records.  The body may replace the
text (`s.log = ...`, a tuple for several lines, None for none).

Spans never synchronise the device, and never touch its memory statistics.
"""

from __future__ import annotations

import functools
import itertools
import sys
import threading
import time

import torch

PREFIX = "raven:"

_profiling = torch._C._autograd._profiler_enabled
_ids = itertools.count(1)
_open = threading.local()  # .stack: this thread's live spans, outermost first
_log: list = []


class Record:
    """One finished span of the log."""

    __slots__ = ("name", "id", "parent", "root", "start", "end", "counts")

    def __init__(self, name, id_, parent, root, start, end, counts):
        self.name = name
        self.id = id_
        self.parent = parent
        self.root = root
        self.start = start  # ns, Unix epoch
        self.end = end
        self.counts = counts

    def __repr__(self) -> str:
        return (f"Record({self.name!r}, id={self.id}, parent={self.parent}, "
                f"root={self.root}, {(self.end - self.start) / 1e6:.3f} ms, {self.counts})")


class span:
    """A step of the program; see the module's docstring."""

    __slots__ = ("name", "counts", "log", "_range", "_id", "_parent", "_root", "_start", "_t0")

    def __init__(self, name: str, log=None, **counts):
        self.name = name
        self.counts = counts
        self.log = log
        self._range = None

    def __setitem__(self, key: str, value) -> None:
        self.counts[key] = value

    def __enter__(self):
        self._t0 = time.perf_counter()
        if _profiling():
            stack = getattr(_open, "stack", None)
            if stack is None:
                stack = _open.stack = []
            self._id = next(_ids)
            self._parent = stack[-1]._id if stack else None
            self._root = stack[0]._id if stack else self._id
            stack.append(self)
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
            self._start = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._range is not None:
            end = time.time_ns()
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
            _open.stack.pop()
            _log.append(Record(self.name, self._id, self._parent, self._root,
                               self._start, end, self.counts))
        if self.log is not None and exc_type is None:
            seconds = time.perf_counter() - self._t0
            for line in (self.log,) if isinstance(self.log, str) else self.log:
                print(f"{line} {seconds:.6f}s", file=sys.stderr)
        return False


def spanned(name: str):
    """Decorator: every call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def spans() -> list:
    """The log: every finished live span, in the order they ended."""
    return _log


def clear() -> None:
    """Empty the log."""
    _log.clear()
