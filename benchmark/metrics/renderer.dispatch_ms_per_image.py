"""Host milliseconds an image that the renderer spends enqueueing its
chunks: its own SpanTracer spans "dispatch chained chunk" and "dispatch
sweep", summed over the window's images, over the images."""


def read(run):
    if not run["images"]:
        return None
    return sum(j["dispatch_s"] for j in run["jobs"]) * 1e3 / run["images"]
