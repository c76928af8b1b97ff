"""Device nanoseconds of the mega trace kernels (``trace_reduce.TRACE_GROUPS``:
K4 or K1, K2 in its thread and tail modes and its survivor scan) a
trace-table row they visited: their device time in the profiler's trace of
the window over the ``rows_visited`` (and an overflow retry's
``retry_rows_visited``) in the args of the program's ``render`` spans
inside the window (``hijiki_tpu_torch.utils.tracing.recent``)."""

from trace_reduce import TRACE_GROUPS, group_of


def read(run):
    try:
        from hijiki_tpu_torch.utils.tracing import recent
    except ImportError:  # a program without the record of its spans
        return None
    tr = run["trace"]
    renders = [e["args"] for e in recent(tr.start_ns, tr.end_ns)
               if e["name"] == "render" and "rows_visited" in e["args"]]
    rows = sum(a["rows_visited"] + a.get("retry_rows_visited", 0) for a in renders)
    s = sum(tr.seconds_by(group_of).get(g, 0.0) for g in TRACE_GROUPS)
    if not s or not rows:
        return None
    return s * 1e9 / rows
