"""Paths that a phase-capacity overflow dropped, each drop making the
renderer trace its pending chunks again at full capacity
(``Renderer.metrics["overflow_retried"]``), summed over the window's
images, over the images."""


def read(run):
    if not run["images"]:
        return None
    return sum(j["overflow_retried"] for j in run["jobs"]) / run["images"]
