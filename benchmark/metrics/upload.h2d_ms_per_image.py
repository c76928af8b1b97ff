"""Device milliseconds an image of host-to-device copies (each fresh
``Renderer`` baking and uploading its scene tables, the chunks' seed
tables), from the profiler's trace of the window."""


def read(run):
    tr = run["trace"]
    s = tr.seconds_by(lambda n: "h2d" if n.startswith("Memcpy HtoD") else None).get("h2d", 0.0)
    if not s or not run["images"]:
        return None
    return s * 1e3 / run["images"]
