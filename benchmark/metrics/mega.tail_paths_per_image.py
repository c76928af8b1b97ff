"""Paths handed to the last compaction phase (the ``max_bounces`` resume,
which K2 runs in its tail mode, a warp a path) an image: the last entry of
``phase_paths`` in the args of the program's ``render`` spans inside the
traced window (``hijiki_tpu_torch.utils.tracing.recent``), summed, over the
window's images. An overflow retry's paths are counted apart
(``retry_phase_paths``) and left out."""


def read(run):
    try:
        from hijiki_tpu_torch.utils.tracing import recent
    except ImportError:  # a program without the record of its spans
        return None
    tr = run["trace"]
    phases = [e["args"]["phase_paths"] for e in recent(tr.start_ns, tr.end_ns)
              if e["name"] == "render" and "phase_paths" in e["args"]]
    if not phases or not run["images"]:
        return None
    return sum(p[-1] for p in phases if p) / run["images"]
