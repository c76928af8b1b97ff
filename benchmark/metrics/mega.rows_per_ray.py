"""Trace-table rows that the mega walk visited a primary ray: the
``rows_visited`` (and an overflow retry's ``retry_rows_visited``) in the
args of the program's ``render`` spans that lie inside the traced window
(``hijiki_tpu_torch.utils.tracing.recent``: the spans share the profiler's
clock), over the window's primary rays. Times ``mega.trace_ns_per_row`` it
is ``mega.trace_ms_per_mray``: work a ray times time a unit of work."""


def read(run):
    try:
        from hijiki_tpu_torch.utils.tracing import recent
    except ImportError:  # a program without the record of its spans
        return None
    tr = run["trace"]
    renders = [e["args"] for e in recent(tr.start_ns, tr.end_ns)
               if e["name"] == "render" and "rows_visited" in e["args"]]
    if not renders or not run["primary_rays"]:
        return None
    rows = sum(a["rows_visited"] + a.get("retry_rows_visited", 0) for a in renders)
    return rows / run["primary_rays"]
