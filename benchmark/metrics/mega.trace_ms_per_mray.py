"""Device milliseconds of the mega trace kernels (K4 or K1, K2 in its
thread and tail modes and its survivor scan) a million primary rays, from
the profiler's trace of the window."""

from trace_reduce import TRACE_GROUPS, group_of


def read(run):
    tr = run["trace"]
    s = sum(tr.seconds_by(group_of).get(g, 0.0) for g in TRACE_GROUPS)
    if not s or not run["primary_rays"]:
        return None
    return s * 1e3 / (run["primary_rays"] / 1e6)
