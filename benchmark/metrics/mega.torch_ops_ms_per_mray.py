"""Device milliseconds of the kernels that are not hand-written (the
compaction's torch ops, the film add, seeds, fills) a million primary
rays, from the profiler's trace of the window. Copies between host and
device (``upload.h2d_ms_per_image``, ``image.copy_ms_per_image``), copies
on the device and memsets are left out."""

from trace_reduce import group_of, is_copy


def read(run):
    tr = run["trace"]
    s = tr.seconds_by(lambda n: "torch" if group_of(n) is None and not is_copy(n) else None).get("torch", 0.0)
    if not s or not run["primary_rays"]:
        return None
    return s * 1e3 / (run["primary_rays"] / 1e6)
