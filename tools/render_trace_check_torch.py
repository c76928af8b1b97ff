"""Hold the port's render record (``hijiki_tpu_torch.utils.tracing``) to
torch.profiler on the card, in a traced window of a benchmark cell:

* every ``render`` span lies inside its image's ``job: render()`` profiler
  range (the spans and the profiler share one clock): the largest part of a
  span outside it, in ms;
* each render's ``device_ms`` (CUDA events around its chunks) against the
  profiler's device busy time inside the span, and against the device's
  elapsed time from the span's first device op to its last (busy plus the
  device's waits for the host between them): the ratios;
* ``mega.rows_per_ray`` x ``mega.trace_ns_per_row`` against
  ``mega.trace_ms_per_mray``, and every per-layer reading of the window.

    python tools/render_trace_check_torch.py --workload cbox-spheres.cli-default \\
        --seed 7 --seconds 10 [--json trace_check.json]

Runs on a CUDA card only (the harness's set-up and window, ``benchmark/``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]

import harness  # noqa: E402
from trace_reduce import TRACE_GROUPS, group_of  # noqa: E402


def busy_in(device: list, a: float, b: float) -> float:
    """The union of the device intervals [(name, start, end)], sorted by
    start, clipped to [a, b], in ns."""
    union, end = 0.0, None
    for _, s, e in device:
        s, e = max(s, a), min(e, b)
        if e <= s:
            continue
        if end is None or s >= end:
            union += e - s
            end = e
        elif e > end:
            union += e - end
            end = e
    return union


def check(workload: str, seed: int, seconds: float, **bench_kw) -> dict:
    """One traced window of ``workload``; ``bench_kw`` go to ``harness.Bench``
    (a CPU rehearsal: ``device="cpu"`` and a small ``traffic``)."""
    from hijiki_tpu_torch.utils.tracing import recent

    bench = harness.Bench(workload, seed, **bench_kw)
    win = bench.window(seed, seconds, True)
    tr = win["trace"]
    renders = [e for e in recent(tr.start_ns, tr.end_ns) if e["name"] == "render"]
    jobs = [(a, b) for name, a, b in tr.host if name == harness.JOB_RANGES[1]]
    outside, ratios, spans, idle = [], [], [], []
    for e in renders:
        a, b = e["ts"] * 1e3, (e["ts"] + e["dur"]) * 1e3
        ja, jb = max(jobs, key=lambda j: min(j[1], b) - max(j[0], a))
        outside.append(max(ja - a, b - jb, 0.0) / 1e6)
        busy = busy_in(tr.device, a, b)
        if busy > 0 and "device_ms" in e["args"]:
            ratios.append(e["args"]["device_ms"] * 1e6 / busy)
        # the device's idle inside the span: before its first trace kernel,
        # from there to its last device op, after that
        ops = [(s, t) for name, s, t in tr.device if a <= s < b]
        first = next((s for name, s, t in tr.device
                      if a <= s < b and group_of(name) in TRACE_GROUPS), None)
        if ops and "device_ms" in e["args"]:
            elapsed = max(t for _, t in ops) - min(s for s, _ in ops)
            spans.append(e["args"]["device_ms"] * 1e6 / elapsed)
        if ops and first is not None:
            last = max(t for _, t in ops)
            idle.append([(c - d - busy_in(tr.device, d, c)) / 1e6
                         for d, c in ((a, first), (first, last), (last, b))])
    t = bench.traffic
    n = len(win["jobs"])
    facts = {"setup": bench.setup, "traffic": t, "config": bench.cell.config, "images": n,
             "window_s": win["window_s"], "primary_rays": n * t["width"] * t["height"] * t["spp"],
             "jobs": win["jobs"], "trace": tr,
             "device_kind": bench.torch.cuda.get_device_name(bench.dev) if bench.cuda else "cpu"}
    reads = {m["name"]: read(facts) for m, read in bench.cell.readers()}
    parts = [reads.get(k) for k in ("mega.rows_per_ray", "mega.trace_ns_per_row",
                                    "mega.trace_ms_per_mray")]
    identity = parts[0] * parts[1] / parts[2] if None not in parts else None
    def quartiles(v):
        q = statistics.quantiles(v, n=4) if len(v) > 1 else v * 3
        return {"min": min(v, default=None), "q1": q[0] if q else None,
                "median": q[1] if q else None, "q3": q[2] if q else None,
                "max": max(v, default=None), "n": len(v)}

    card = harness.card_line() if bench.cuda else "none"
    return {"workload": workload, "seed": seed, "card": card, "images": n,
            "render_spans": len(renders), "job_ranges": len(jobs),
            "max_ms_outside_job": max(outside, default=None),
            "device_ms_over_busy": quartiles(ratios),
            "device_ms_over_elapsed": quartiles(spans),
            "rows_x_ns_over_trace_ms_per_mray": identity,
            "render_idle_ms_median": {k: statistics.median(v[i] for v in idle) if idle else None
                                      for i, k in enumerate(("before_first_trace_kernel",
                                                             "from_it_to_the_last_op",
                                                             "after_the_last_op"))},
            "per_layer": reads}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, action="append")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    harness.run_env()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    out = [check(w, args.seed + i, args.seconds) for i, w in enumerate(args.workload)]
    for r in out:
        print(json.dumps(r), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
