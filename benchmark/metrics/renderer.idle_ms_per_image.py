"""Device idle milliseconds an image inside the program's ``render`` spans
(``Renderer.render``: the chunks' dispatch, the overflow read, the film's
sync): the idle gaps of the profiler's trace of the window, clipped to the
spans that lie inside it (``hijiki_tpu_torch.utils.tracing.recent``: the
spans share the profiler's clock), summed, over the window's images. The
idle that the render loop causes, apart from the idle between renders."""

import bisect

SPAN = "render"


def covered_ns(gaps, spans) -> float:
    """The part of the gaps [(start, length)] that the union of the spans
    [(start, end)] covers, in ns."""
    union = []
    for a, b in sorted(spans):
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    starts = [a for a, _ in union]
    total = 0.0
    for g0, n in gaps:
        g1 = g0 + n
        i = max(0, bisect.bisect_right(starts, g0) - 1)
        while i < len(union) and union[i][0] < g1:
            total += max(0.0, min(union[i][1], g1) - max(union[i][0], g0))
            i += 1
    return total


def read(run):
    try:
        from hijiki_tpu_torch.utils.tracing import recent
    except ImportError:  # a program without the record of its spans
        return None
    tr = run["trace"]
    spans = [(e["ts"] * 1e3, (e["ts"] + e["dur"]) * 1e3) for e in recent(tr.start_ns, tr.end_ns)
             if e["name"] == SPAN]
    if not spans or not run["images"]:
        return None
    return covered_ns(tr.gaps(), spans) / 1e6 / run["images"]
