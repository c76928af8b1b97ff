"""The benchmark of the PyTorch/CUDA port (``hijiki_tpu_torch``): one cell,
one run.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell (``BENCHMARK.json`` ``workloads``) names a configuration (a scene:
``configs/<name>.json``) and a traffic mix (a render job's parameters:
``traffic/<name>.json``); its limits of ``correct`` are in
``limits/<workload>.json`` and each per-layer metric is read by
``metrics/<metric>.py``. All are found by name: a new cell, scene, job or
metric is a new file and a new entry, never an edit.

A run is a render-farm node working through a queue of frames with one
client, in a closed loop: each image is a fresh ``Renderer`` over the
compiled scene, ``render()``, and the image read to the host
(``Renderer.image()``); image i renders with a seed made from ``--seed``
and i. Set-up (``setup_s``) builds or loads the kernels, parses the scene
and compiles it, and renders one warm-up image of the cell's shape. The
window then starts images while ``--seconds`` have not passed and ends
when the last of them is on the host. ``--trace 1`` runs the same window
under torch.profiler and reports the per-layer metrics instead of the
end-to-end ones. After the window the plain reference (``reference.py``)
computes the pixels that ``check.py`` samples from the window's images;
the run prints each compared number beside its limit last on standard
error and last in its result line.

Exits 3 without a result where no CUDA card (or fewer than the cell's) is
present, and 4 where jax, jaxlib, flax or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import traceback
from contextlib import contextmanager

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "hijiki_tpu")
# the host ranges that label the device's idle gaps: the benchmark's own
# around each call of a job, and the renderer's spans
JOB_RANGES = ("job: Renderer()", "job: render()", "job: image()")
RENDERER_SPANS = ("dispatch chained chunk", "dispatch sweep", "overflow check (host sync)",
                  "film ready", "retry chunk (full capacity)")
DISPATCH_SPANS = ("dispatch chained chunk", "dispatch sweep")
# the profiler range around the measured window: the traced window
WINDOW_RANGE = "window"


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic,
    limits and per-layer readers, found by name."""

    def __init__(self, workload: str):
        self.spec = load_json(os.path.join(ROOT, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json (one of {', '.join(cells)})")
        self.cell = cells[workload]
        self.name = workload
        entry = next(c for c in self.spec["configs"] if c["name"] == self.cell["config"])
        self.config = load_json(os.path.join(ROOT, entry["file"]))
        self.traffic = load_json(os.path.join(BENCH, "traffic", self.cell["traffic"] + ".json"))
        self.limits = load_json(os.path.join(BENCH, "limits", workload + ".json"))
        self.end_to_end = [m for m in self.spec["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in self.spec["per_layer"]
                          if workload in m.get("workloads", [workload])]

    def readers(self) -> list:
        out = []
        for m in self.per_layer:
            path = os.path.join(BENCH, "metrics", m["name"] + ".py")
            spec = importlib.util.spec_from_file_location("bench_metric_" + m["name"].replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            out.append((m, mod.read))
        return out


def job_seed(seed: int, *path: int) -> int:
    """A job's 64-bit render seed from the run's seed and the job's place."""
    return int(np.random.SeedSequence([seed % 2**64, *path]).generate_state(1, np.uint64)[0])


def p95(values) -> float:
    """The nearest-rank 95th percentile: the smallest value that at least
    95% of the values do not exceed."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def run_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port's own nvcc and g++ libraries, and its shadow-visibility boxes,
    already live under ``build/`` there); one intra-op CPU thread (set
    before torch is imported): the render's host work is one Python thread,
    and a pool of spinning threads on the shared cores delayed ~10% of the
    short frames of a 1-spp job by ~10 ms in some runs and not in others."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"


def port_scene(raw):
    """The program's ``Scene`` of the raw scene, through its own entries."""
    from hijiki_tpu_torch.scene import model

    scene = model.Scene(camera=model.Camera(position=raw.cam_position.copy(),
                                            rotation=raw.cam_rotation.copy(), fov=raw.cam_fov))
    for m in raw.materials:
        t = m["type"]
        if t == "diffuse":
            mat = model.Diffuse(tuple(m["color"]))
        elif t == "checkerboard":
            mat = model.DiffuseCheckerboard(tuple(m["color1"]), m["scale_u"], tuple(m["color2"]), m["scale_v"])
        elif t == "mirror":
            mat = model.Mirror()
        elif t == "dielectric":
            mat = model.Dielectric(tuple(m.get("extinction", (0.0, 0.0, 0.0))), m["eta"])
        else:
            mat = model.Emissive(tuple(m["power"]))
        scene.add_material(mat)
    for center, radius, mi in raw.spheres:
        scene.add_object(model.Sphere(tuple(float(x) for x in center), float(radius)), mi)
    scene.positions, scene.normals, scene.uvs = raw.positions, raw.normals, raw.uvs
    scene.add_triangles_bulk(raw.tris, raw.tri_mat)
    return scene


def render_config(traffic: dict, seed: int):
    from hijiki_tpu_torch.render.renderer import RenderConfig

    return RenderConfig(width=traffic["width"], height=traffic["height"], spp=traffic["spp"],
                        block_size=traffic["block_size"], seed=seed,
                        max_bounces=traffic["max_bounces"],
                        reconstruction_radius=traffic["reconstruction_radius"],
                        reconstruction_stddev=traffic["reconstruction_stddev"])


def span_tracer():
    """The port's SpanTracer whose spans also open a profiler range, so the
    trace can say what the host was doing in each idle gap."""
    import torch
    from hijiki_tpu_torch.utils.tracing import SpanTracer

    class ProfiledTracer(SpanTracer):
        @contextmanager
        def span(self, name, **args):
            with torch.profiler.record_function(name), super().span(name, **args) as extra:
                yield extra

    return ProfiledTracer()


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or "nvidia-smi: not available"


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the modules
    loaded), each compared whole: ``hijiki_tpu_torch`` is not ``hijiki_tpu``."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)} & set(FORBIDDEN))


class Bench:
    """A cell's set-up on ``device``: the kernels loaded, the scene parsed
    and compiled, one warm-up image rendered. The tests pass a small
    ``traffic`` and a broken ``renderer_class`` to drive a run on the CPU."""

    def __init__(self, workload: str, seed: int, *, device: str = "cuda", traffic: dict = None,
                 renderer_class=None, t_start: float = None):
        t_setup = time.perf_counter() if t_start is None else t_start
        self.cell = Cell(workload)
        self.traffic = dict(self.cell.traffic if traffic is None else traffic)
        if BENCH not in sys.path:
            sys.path.insert(0, BENCH)
        import torch

        if torch.device(device).type == "cuda":
            run_env()
            torch.set_num_threads(1)

        import scene_input
        from hijiki_tpu_torch.render.renderer import Renderer
        from hijiki_tpu_torch.scene.compile import compile_scene

        self.torch = torch
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        self.renderer_class = renderer_class or Renderer
        setup = self.setup = {"imports_s": time.perf_counter() - t_setup}
        # the kernels: built once per checkout, then loaded
        t0 = time.perf_counter()
        if self.cuda:
            from hijiki_tpu_torch.utils.build import load_library

            load_library()
        setup["kernels_s"] = time.perf_counter() - t0
        # the scene: parse, compile (BVH, trace rows, shadow table and
        # boxes), and its first bake onto the device, in the warm-up Renderer
        t0 = time.perf_counter()
        self.raw = scene_input.load_scene(self.cell.config, ROOT)
        self.cs = compile_scene(port_scene(self.raw), **self.cell.config.get("compile", {}))
        warm = self.renderer_class(self.cs, render_config(self.traffic, job_seed(seed, 1)),
                                   device=self.dev)
        self.sync()
        setup["scene_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm.render()
        warm.image()
        del warm
        self.sync()
        setup["warmup_s"] = time.perf_counter() - t0
        setup["setup_s"] = time.perf_counter() - t_setup
        self.setup_peak = torch.cuda.max_memory_allocated(self.dev) if self.cuda else 0

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.dev)

    def window(self, seed: int, seconds: float, trace: bool) -> dict:
        """Images back to back while ``seconds`` have not passed, one client;
        image i renders with ``job_seed(seed, 2, i)``. Returns the jobs'
        timings and counters, the reservoir of images to check, and, with
        ``trace``, the profiler's Trace of the window."""
        import check
        from trace_reduce import Trace

        torch = self.torch
        keep = check.Reservoir(int(self.traffic["check"]["images"]), seed)
        jobs, failed = [], 0
        prof = None
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)
            mallocs = torch.cuda.memory_stats(self.dev).get("num_device_alloc", 0)
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            prof = profile(activities=acts)
            prof.__enter__()
        rf = torch.profiler.record_function
        window = rf(WINDOW_RANGE)
        window.__enter__()
        t_start = time.perf_counter()
        i = 0
        while time.perf_counter() - t_start < seconds:
            js = job_seed(seed, 2, i)
            tracer = span_tracer() if trace else None
            j0 = time.perf_counter()
            try:
                with rf(JOB_RANGES[0]):
                    r = self.renderer_class(self.cs, render_config(self.traffic, js), device=self.dev)
                    r.tracer = tracer
                with rf(JOB_RANGES[1]):
                    r.render()
                with rf(JOB_RANGES[2]):
                    img = r.image()
            except Exception:  # a job that fails is counted, and the run goes on
                traceback.print_exc()
                failed += 1
                i += 1
                continue
            j1 = time.perf_counter()
            dispatch = 0.0
            if tracer is not None:
                dispatch = sum(e["dur"] for e in tracer.events if e["name"] in DISPATCH_SPANS) / 1e6
            jobs.append({"seconds": j1 - j0, "end": j1, "dispatch_s": dispatch,
                         "overflow_retried": int(r.metrics.get("overflow_retried", 0))})
            # only the checked pixels are kept: holding whole images would
            # change how the host's allocator serves the next ones
            keep.offer((i, js, check.program_pixels(img, self.corners(seed, i))))
            del r, img
            i += 1
        self.sync()
        window.__exit__(None, None, None)
        out = {"jobs": jobs, "failed": failed, "attempted": i, "kept": keep.kept,
               "window_s": max([t_start] + [j["end"] for j in jobs]) - t_start,
               "peak": torch.cuda.max_memory_allocated(self.dev) if self.cuda else 0, "trace": None,
               "device_mallocs": (torch.cuda.memory_stats(self.dev).get("num_device_alloc", 0) - mallocs
                                  if self.cuda else 0)}
        if prof is not None:
            prof.__exit__(None, None, None)
            out["trace"] = Trace.from_profile(prof, set(JOB_RANGES + RENDERER_SPANS), WINDOW_RANGE)
        return out

    def free_program(self):
        """Drop the program's state before the reference runs."""
        del self.cs
        if self.cuda:
            self.torch.cuda.empty_cache()

    def corners(self, seed: int, index: int):
        """The checked patches' corners in image ``index`` of a run."""
        import check

        t = self.traffic
        return check.patch_corners(seed, index, t["width"], t["height"], t["block_size"],
                                   int(t["check"]["patches"]))

    def check(self, seed: int, kept, dtypes=None) -> list:
        """Each kept image's checked pixels: [program, reference] and, for
        each extra dtype in ``dtypes``, the reference computed in it."""
        import check
        from reference import Reference

        refs = [Reference(self.raw, self.dev, dt) for dt in [self.torch.float32] + list(dtypes or ())]
        out = []
        for idx, js, pixels in kept:
            job = dict(self.traffic, seed=js)
            out.append([pixels] + [check.reference_pixels(r, self.raw, job, self.corners(seed, idx))
                                   for r in refs])
        return out


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def run(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
        traffic: dict = None, renderer_class=None, t_start: float = None) -> dict:
    """One run of a cell on ``device``; returns the result object."""
    bench = Bench(workload, seed, device=device, traffic=traffic, renderer_class=renderer_class,
                  t_start=t_start)
    import check

    cell, traffic, setup = bench.cell, bench.traffic, bench.setup
    win = bench.window(seed, seconds, trace)
    jobs, n, window_s = win["jobs"], len(win["jobs"]), win["window_s"]
    rays = n * traffic["width"] * traffic["height"] * traffic["spp"]
    kind = bench.torch.cuda.get_device_name(bench.dev) if bench.cuda else "cpu"
    result = {"correct": False, "attempted": win["attempted"], "failed": win["failed"], "metrics": {},
              "device": {"platform": "gpu" if bench.cuda else "cpu", "kind": kind, "count": 1,
                         "memory_peak_bytes": int(max(bench.setup_peak, win["peak"]))}}
    if trace:
        tr = win["trace"]
        result["device"]["busy_s"] = tr.busy_ns() / 1e9
        result["device"]["window_s"] = tr.window_s
        facts = {"setup": setup, "traffic": traffic, "config": cell.config, "images": n,
                 "window_s": window_s, "primary_rays": rays, "jobs": jobs, "trace": tr,
                 "device_kind": kind}
        for m, read in cell.readers():
            v = read(facts)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = tr.breakdown()
        win["trace"] = tr = None
    else:
        e2e = window_metrics(jobs, window_s, traffic)
        e2e["peak_mem_mib"] = win["peak"] / 2**20 if bench.cuda else None
        e2e["setup_s"] = setup["setup_s"]
        for m in cell.end_to_end:
            if e2e.get(m["name"]) is not None:
                result["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    log(f"{workload} seed {seed}: {n} images in {window_s:.3f} s, {win['failed']} failed; "
        f"set-up {setup['setup_s']:.3f} s (imports and card {setup['imports_s']:.3f}, kernels "
        f"{setup['kernels_s']:.3f}, scene {setup['scene_s']:.3f}, warm-up image {setup['warmup_s']:.3f}); "
        f"card: {card_line() if bench.cuda else 'none'}")
    if n:
        q = np.percentile([j["seconds"] * 1e3 for j in jobs], [0, 50, 90, 95, 99, 100])
        log("image ms min/p50/p90/p95/p99/max: " + " / ".join(f"{x:.3f}" for x in q)
            + f"; device allocations in the window: {win['device_mallocs']}")
    # correct: the kept images against the plain reference, once the
    # program's state is freed
    bench.free_program()
    t0 = time.perf_counter()
    pairs = bench.check(seed, win["kept"])
    gaps = [check.gaps(prog, want) for prog, want in pairs]
    read = check.readings(np.concatenate(gaps) if gaps else np.zeros(0))
    lim = {k: cell.limits[k] for k in check.COMPARED}
    result["correct"] = bool(n > 0 and win["failed"] == 0 and check.within(read, lim))
    result["checks"] = {k: {"value": read[k], "limit": lim[k]} for k in lim}
    log(f"checked {sum(g.size for g in gaps)} pixels of {len(pairs)} images against the "
        f"reference in {time.perf_counter() - t0:.3f} s")
    return result


def window_metrics(jobs: list, window_s: float, traffic: dict) -> dict:
    """The rate over all the window's work and time, and the tail of all
    its images."""
    if not jobs:
        return {}
    rays = len(jobs) * traffic["width"] * traffic["height"] * traffic["spp"]
    return {"mrays_per_s": rays / window_s / 1e6,
            "image_p95_ms": p95([j["seconds"] for j in jobs]) * 1e3}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_start = time.perf_counter()
    cell = Cell(args.workload)
    run_env()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell.cell["chips"]):
        print(f"needs {cell.cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)} (the benchmark runs the port alone)",
              file=sys.stderr)
        return 4
    checks = result["checks"]
    print("; ".join(f"{k} {v['value']} <= {v['limit']}" for k, v in checks.items()),
          file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
