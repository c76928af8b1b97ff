"""Host-span tracing: a Chrome-trace (``chrome://tracing`` / Perfetto)
timeline of the driver loop.

Port of ``hijiki_tpu/utils/tracing.py`` (pure Python). The renderer records
what the host observes: per-chunk dispatch spans, the overflow check, the
film sync (``torch.cuda.synchronize`` on a card), overflow retries and
checkpoint saves, with the kernels' counters attached as Chrome-trace args.
Kernel-level device time comes from ``torch.profiler``
(``tools/profile_torch_slice.py``).

Usage:
    tracer = SpanTracer()
    with tracer.span("render", spp=64):
        ...
    tracer.write("render_trace.json")   # load in ui.perfetto.dev

or from the CLI: ``--trace-json trace.json``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Optional


class SpanTracer:
    """Records complete-events (ph="X") and counters (ph="C") in the
    Chrome trace-event format. Thread-safe; timestamps are µs since the
    tracer's creation (monotonic clock)."""

    def __init__(self) -> None:
        self._t0 = time.monotonic()
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._pid = os.getpid()

    def _now_us(self) -> float:
        return (time.monotonic() - self._t0) * 1e6

    @contextmanager
    def span(self, name: str, **args: Any):
        """Context manager recording one complete event. Extra kwargs are
        attached as the event's args; a mutable dict is yielded so values
        known only at exit (e.g. the overflow count after the host sync)
        can be added."""
        start = self._now_us()
        extra: dict = {}
        try:
            yield extra
        finally:
            end = self._now_us()
            ev = {
                "name": name,
                "ph": "X",
                "ts": start,
                "dur": end - start,
                "pid": self._pid,
                "tid": threading.get_ident() % 1_000_000,
                "args": {**args, **extra},
            }
            with self._lock:
                self._events.append(ev)

    def instant(self, name: str, **args: Any) -> None:
        with self._lock:
            self._events.append(
                {
                    "name": name,
                    "ph": "i",
                    "s": "p",
                    "ts": self._now_us(),
                    "pid": self._pid,
                    "tid": threading.get_ident() % 1_000_000,
                    "args": dict(args),
                }
            )

    def counter(self, name: str, **values: float) -> None:
        """One counter sample (renders as a stacked chart track)."""
        with self._lock:
            self._events.append(
                {
                    "name": name,
                    "ph": "C",
                    "ts": self._now_us(),
                    "pid": self._pid,
                    "args": {k: float(v) for k, v in values.items()},
                }
            )

    @property
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def write(self, path: str) -> None:
        """Write the trace; load in chrome://tracing or ui.perfetto.dev."""
        with self._lock:
            # snapshot inside the lock: json.dump iterates lazily, and a
            # span ending mid-serialization would mutate the live list
            events = list(self._events)
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
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
