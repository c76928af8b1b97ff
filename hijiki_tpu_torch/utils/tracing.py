"""Host-span tracing: a Chrome-trace (``chrome://tracing`` / Perfetto)
timeline of the driver loop.

Port of ``hijiki_tpu/utils/tracing.py`` (pure Python). The renderer records
what the host observes, as one tree a render:

    render                        the render's counters, chunks, sweeps,
    ├── dispatch chained chunk    overflow, rate and device_ms in its args
    │   (or dispatch sweep)       one a chunk, with its device_ms
    ├── overflow check (host sync)
    │   └── retry chunk (full capacity)   one a retried chunk
    └── film ready
    image                         Renderer.image()
    ├── normalize film
    └── copy to host

Every span carries an ``id``, the ``parent`` id of the innermost span open
on its thread when it began, and the ``render`` id of the ``render`` span
around it (None outside a render). Times are on the clock that
torch.profiler stamps its host events with (Unix epoch; a span's ``ts`` and
``dur`` in µs), taken as ``time.monotonic_ns()`` plus an offset fixed when
the tracer is created, so a step of the wall clock cannot reorder spans: a
``--trace-json`` file lies on the same time axis as a ``--profile-dir``
trace of the same render. Device time comes from CUDA events that the
renderer records around each chunk while a tracer is attached (the
``device_ms`` args), and kernel by kernel from torch.profiler (the CLI's
``--profile-dir``).

Every finished event of every tracer also goes into one bounded record of
the process (the last ``RECORD_SIZE``), which ``recent(start_ns, end_ns)``
reads: an operator, or a reader of the benchmark, takes the spans of a
window without holding the tracer. With no tracer attached nothing is
recorded and nothing is allocated.

Usage:
    tracer = SpanTracer()
    with tracer.span("render", spp=64):
        ...
    tracer.write("render_trace.json")   # load in ui.perfetto.dev

or from the CLI: ``--trace-json trace.json``.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Optional

# the span whose id every span inside it carries as its ``render``
RENDER_SPAN = "render"
# the events the process-wide record keeps (a traced 30 s window of the
# benchmark makes ~4,000)
RECORD_SIZE = 65_536

_LOCK = threading.Lock()
_RECORD: collections.deque = collections.deque(maxlen=RECORD_SIZE)
_IDS = itertools.count(1)
# per thread: the (id, render id) of each open span, innermost last
_OPEN = threading.local()


def recent(start_ns: int, end_ns: int) -> list[dict]:
    """The recorded events (of any tracer of this process, the last
    ``RECORD_SIZE``) that lie inside [start_ns, end_ns] on the tracers'
    clock (Unix epoch ns), in the order they finished."""
    lo, hi = start_ns / 1e3, end_ns / 1e3
    with _LOCK:
        return [e for e in _RECORD if lo <= e["ts"] and e["ts"] + e.get("dur", 0.0) <= hi]


def _open_spans() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


class SpanTracer:
    """Records complete-events (ph="X") and counters (ph="C") in the
    Chrome trace-event format. Thread-safe; timestamps are µs on the
    profiler's clock (Unix epoch), kept monotonic within the tracer."""

    def __init__(self) -> None:
        self._offset_ns = time.time_ns() - time.monotonic_ns()
        self._events: list[dict] = []
        self._pid = os.getpid()

    def now_ns(self) -> int:
        """Unix-epoch ns on this tracer's monotonic clock."""
        return time.monotonic_ns() + self._offset_ns

    def _add(self, ev: dict) -> None:
        with _LOCK:
            self._events.append(ev)
            _RECORD.append(ev)

    @contextmanager
    def span(self, name: str, **args: Any):
        """Context manager recording one complete event. Extra kwargs are
        the event's args; the args dict itself is yielded, so values known
        only at exit (e.g. the overflow count after the host sync) can be
        added, and it stays the event's: a value resolved later (a CUDA
        event's ``device_ms`` after the film's sync) lands in the event."""
        stack = _open_spans()
        parent, render = stack[-1] if stack else (None, None)
        sid = next(_IDS)
        if name == RENDER_SPAN:
            render = sid
        entry = (sid, render)
        stack.append(entry)
        extra: dict = dict(args)
        start = self.now_ns()
        try:
            yield extra
        finally:
            end = self.now_ns()
            stack.remove(entry)
            self._add({
                "name": name,
                "ph": "X",
                "ts": start / 1e3,
                "dur": (end - start) / 1e3,
                "pid": self._pid,
                "tid": threading.get_ident() % 1_000_000,
                "id": sid,
                "parent": parent,
                "render": render,
                "args": extra,
            })

    def counter(self, name: str, **values: float) -> None:
        """One counter sample (renders as a stacked chart track)."""
        self._add({
            "name": name,
            "ph": "C",
            "ts": self.now_ns() / 1e3,
            "pid": self._pid,
            "args": {k: float(v) for k, v in values.items()},
        })

    @property
    def events(self) -> list[dict]:
        with _LOCK:
            return list(self._events)

    def write(self, path: str) -> None:
        """Write the trace; load in chrome://tracing or ui.perfetto.dev."""
        # snapshot inside the lock: json.dump iterates lazily, and a span
        # ending mid-serialization would mutate the live list
        doc = {"traceEvents": self.events, "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(doc, f)


def maybe_span(tracer: Optional[SpanTracer], name: str, **args: Any):
    """tracer.span(...) or a no-op context (the renderer's loop uses this so
    the untraced path allocates nothing)."""
    if tracer is not None:
        return tracer.span(name, **args)
    return _NULL_CTX


class _NullCtx:
    def __enter__(self):
        return {}

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()
