"""K3's share of its roofline: the least time its launches could take
(``peaks.k3_bound_s``: from shapes alone, at the H100's 3.35 TB/s and 67
TFLOP/s f32) over their device time in the profiler's trace."""

from peaks import k3_bound_s
from trace_reduce import group_of

K3 = "K3 reconstruct"


def read(run):
    tr = run["trace"]
    secs = tr.seconds_by(group_of).get(K3, 0.0)
    launches = tr.count(lambda n: group_of(n) == K3)
    if not secs or not launches:
        return None
    t = run["traffic"]
    bound = k3_bound_s(t["width"] * t["height"], run["images"] * t["spp"], launches,
                       run["device_kind"])
    return 100.0 * bound / secs
