"""Device milliseconds an image of device-to-host copies (the film's
normalized image read to the host by ``Renderer.image()``, and any other
host read), from the profiler's trace of the window."""


def read(run):
    tr = run["trace"]
    s = tr.seconds_by(lambda n: "d2h" if n.startswith("Memcpy DtoH") else None).get("d2h", 0.0)
    if not s or not run["images"]:
        return None
    return s * 1e3 / run["images"]
