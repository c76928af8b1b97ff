"""A/B of the megakernel's chained camera launch (K4) and resume launch (K2),
and of the walk they share, between the package's csrc/ and another build,
on one CUDA card.

    python tools/ab_megakernel_torch.py PARENT_CSRC [--variants walk,loop,NAME=DIR]
                                        [--reps 10] [--json PATH] [--sass DIR]

PARENT_CSRC is a directory holding another commit's
``hijiki_tpu_torch/csrc`` files, inside the repository when a remote machine
runs the tool (the ignored ``build/`` is a good place):

    mkdir -p build/ab/parent
    git archive <commit> hijiki_tpu_torch/csrc | tar -x --strip-components=2 -C build/ab/parent

Each library is built from ``megakernel.cu``, ``probe_walk.cu`` and the
headers of its tree (``utils.build.build``, one nvcc per source, all
libraries at once, never from the cache: its ptxas report is wanted) and
loaded with ctypes; its K4, K2 and K10b (``walk_isolate``) are called at
their C entry points, K4 into zeroed outputs. A library whose
``mk_start_chained`` is persistent (it exports ``mk_occupancy``) takes a
work counter for it, zeroed before each launch. ``--variants`` adds
libraries built from mixed trees: ``walk`` (the parent with the package's
walk.cuh: the row step alone), ``loop`` (the package with the parent's
walk.cuh: the persistent loop alone), ``NAME=DIR`` (the csrc files in
DIR).

What it replays: the chained chunk of ``chip_smoke.py`` phase 6 (the
meshbox + cbox spheres at 1024x1024, 8 sweeps, chain cap 8, max_bounces
1000), recorded through the package's wrappers: its K4 launch and its two
K2 launches (capacities 2,097,152 and 524,288 lanes, caps 48 and 1000); and
``walk_isolate`` on 1024x1024 camera rays and 1M random rays (32-column
table, one thread a ray). Every library's outputs must equal the parent's
bit for bit (int32 views). Times: CUDA events around each launch, the
libraries in turn, ``--reps`` rounds after a warm-up; min and median, and
each library's ratio to the parent.

Also printed: the card's name and power limit; ptxas' registers and spill
stores of each K4, K2 and K10b kernel, and their resident warps an SM (the
runtime's answer where the library exports ``mk_occupancy``, else from the
registers) and K4's blocks; the warp-iteration ratios of the chunk (``mk.warp_iterations``
of K4's ``segs``: what the whole-sample loop, a per-lane loop and perfect
packing cost in warp-bounces); and, where cuobjdump exists, each K4 and K2
kernel's count of BSSY/BSYNC/WARPSYNC/VOTE/SHFL/ATOM instructions and the
loops of K10b's walk (instructions by opcode), with their SASS written to
``--sass`` (default ``build/ab_megakernel/sass``). Needs a CUDA card and
nvcc; imports only the port and chip_smoke's helpers.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))

from chip_smoke import bit_equal, record_calls  # noqa: E402

# the kernels reported, by a part of their mangled names
KERNELS = {"K4": ("mk_start_chained_kernel",),
           "K2": ("mk_resume_kernelILb0E",),
           "K10b": ("walk_isolate_kernelILi32ELb1ELi1E",)}
SASS_OPS = ("BSSY", "BSYNC", "WARPSYNC", "VOTE", "SHFL", "ATOM", "RED")


def stage(name: str, csrc: Path, walk_from: Path | None = None) -> Path:
    """A directory holding what the library ``name`` builds from: csrc's
    megakernel.cu, probe_walk.cu and headers (walk.cuh taken from
    ``walk_from`` if given), its cached build removed."""
    from hijiki_tpu_torch.utils import build

    out = build.BUILD_ROOT.parent / "ab_megakernel" / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for f in [csrc / "megakernel.cu", csrc / "probe_walk.cu", *csrc.glob("*.cuh")]:
        shutil.copy(f, out / f.name)
    if walk_from is not None:
        shutil.copy(walk_from / "walk.cuh", out / "walk.cuh")
    shutil.rmtree(build.BUILD_ROOT / build.cache_key(out), ignore_errors=True)
    return out


def ptxas_table(report: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes)} from ptxas -v."""
    out, name, spill = {}, None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), spill)
            name = None
    return out


def warps_from_registers(regs: int, threads: int = 128) -> int:
    """Resident warps an SM of a kernel of ``regs`` registers a thread in
    blocks of ``threads`` (65,536 registers an SM, allocated 256 a warp; at
    most 32 blocks and 64 warps an SM)."""
    per_warp = -(-regs * 32 // 256) * 256
    blocks = min(65536 // (per_warp * threads // 32), 32, 64 * 32 // threads)
    return blocks * threads // 32


class Lib:
    """One built kernel library and its C entries."""

    def __init__(self, name: str, path: Path, report: str):
        from hijiki_tpu_torch.utils import build

        self.name, self.path, self.report = name, path, report
        self.cdll = ctypes.CDLL(str(path))
        self.persistent = hasattr(self.cdll, "mk_occupancy")
        for fn in ["mk_start_chained", "mk_resume", "walk_isolate"] + ["mk_occupancy"] * self.persistent:
            argtypes = list(build.SIGNATURES[fn])
            if fn == "mk_start_chained" and not self.persistent:
                del argtypes[-2]  # a K4 that is not persistent takes no work counter
            getattr(self.cdll, fn).argtypes = argtypes
            getattr(self.cdll, fn).restype = ctypes.c_int

    def call(self, fn: str, ms, *args, counter=None):
        import torch

        from hijiki_tpu_torch.ops import megakernel as mk

        ptr = lambda a: a.data_ptr() if torch.is_tensor(a) else a
        tail = [counter.data_ptr()] if (self.persistent and fn == "mk_start_chained") else []
        rc = getattr(self.cdll, fn)(ms.rows.data_ptr(), ms.consts.data_ptr(), *mk._scene_args(ms),
                                    *map(ptr, args), *tail,
                                    torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} {fn}: CUDA error {rc}")

    def kernels(self) -> dict:
        """{K4/K2/K10b: (registers, spill store bytes, resident warps an SM,
        K4's persistent blocks or None)}."""
        from hijiki_tpu_torch.ops import megakernel as mk

        table = ptxas_table(self.report)
        out = {}
        for k, parts in KERNELS.items():
            hits = [v for n, v in table.items() if any(p in n for p in parts)]
            if not hits:
                raise RuntimeError(f"{self.name}: ptxas reported no {k} kernel ({parts[0]})")
            regs, spill = hits[0]
            warps, blocks = warps_from_registers(regs), None
            if self.persistent and k != "K10b":
                occ = mk.occupancy({"K4": "mk_start_chained", "K2": "mk_resume"}[k], self.cdll)
                warps = occ["warps_per_sm"]
                blocks = occ["blocks_per_sm"] * occ["sms"] if k == "K4" else None
            out[k] = (regs, spill, warps, blocks)
        return out


def summary(ms_list) -> dict:
    return {"min_ms": min(ms_list), "median_ms": statistics.median(ms_list), "n": len(ms_list)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path, help="a directory holding the parent's csrc/ files")
    ap.add_argument("--variants", default="",
                    help="comma-separated: walk, loop, NAME=DIR")
    ap.add_argument("--reps", type=int, default=10, help="timed launches a library (>= 10)")
    ap.add_argument("--json", help="write the results here")
    ap.add_argument("--sass", type=Path, default=Path(HERE).parent / "build" / "ab_megakernel" / "sass",
                    help="write the K4, K2 and K10b kernels' SASS here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 2
    from hijiki_tpu_torch.ops import megakernel as mk
    from hijiki_tpu_torch.probes import card, op_counts, sass_functions
    from hijiki_tpu_torch.probes import walk_probe as pwk
    from hijiki_tpu_torch.render.renderer import RenderConfig, Renderer, render_sweeps_chained
    from hijiki_tpu_torch.scene.compile import compile_scene
    from hijiki_tpu_torch.scene.obj import load_obj_scene
    from hijiki_tpu_torch.utils import build

    print(card(), flush=True)
    parent = args.parent.resolve()
    if not (parent / "megakernel.cu").exists():
        print(f"error: {parent} holds no megakernel.cu", file=sys.stderr)
        return 2
    trees = {"parent": stage("parent", parent), "new": stage("new", build.CSRC)}
    for v in filter(None, args.variants.split(",")):
        if v == "walk":
            trees[v] = stage(v, parent, walk_from=build.CSRC)
        elif v == "loop":
            trees[v] = stage(v, build.CSRC, walk_from=parent)
        elif "=" in v:
            name, tree = v.split("=", 1)
            trees[name] = stage(name, Path(tree).resolve())
        else:
            raise SystemExit(f"unknown variant {v!r}")
    with ThreadPoolExecutor(len(trees)) as ex:
        built = dict(zip(trees, ex.map(build.build, trees.values())))
    libs = [Lib(name, path, report) for name, (path, _, report) in built.items()]
    dev = torch.device("cuda")
    result = {"card": card(), "libraries": {}}
    print("library: K4 / K2 / K10b registers, spill stores, resident warps an SM, persistent blocks")
    for lib in libs:
        ks = lib.kernels()
        result["libraries"][lib.name] = {"persistent": lib.persistent, "build_s": built[lib.name][1],
                                         "kernels": ks}
        print(f"  {lib.name:14s} built in {built[lib.name][1]:.1f} s; " + "; ".join(
            f"{k} {r} regs, {s} B spilled, {w} warps/SM" + (f", {b} blocks" if b else "")
            for k, (r, s, w, b) in ks.items()), flush=True)

    # the chained chunk's K4 and K2 calls, recorded through the package
    scene = load_obj_scene(pwk.SCENE)
    scene.put_cbox_spheres()
    cs = compile_scene(scene)
    cfg = RenderConfig(width=1024, height=1024, spp=8, max_bounces=1000, block_size=128,
                       use_bvh=True, driver="mega")
    r = Renderer(cs, cfg, device="cuda")
    ms = r.scene
    scheds = [r.scheduler.sweep(cfg.spp + 1 + s) for s in range(mk.CHAIN_SWEEPS_CUDA)]
    calls = record_calls(mk, ["mk_start_chained", "mk_resume"], lambda: render_sweeps_chained(
        ms, np.stack([sc.block_seeds for sc in scheds]),
        np.stack([sc.sample_offset for sc in scheds]), cfg))
    k4_args = next(a for n, a in calls if n == "mk_start_chained")
    k2_args = [a for n, a in calls if n == "mk_resume"]
    pxs, pys, seeds, cap = k4_args
    S, n = pxs.shape
    counter = torch.zeros(1, dtype=torch.int32, device=dev)

    def k4_buffers():
        shapes = ((mk.N_STATE, S * n), (S * n,), (mk.CHAIN_OUT_CH, S * n))
        dts = (torch.float32, torch.int32, torch.float32)
        return [torch.zeros(sh, dtype=dt, device=dev) for sh, dt in zip(shapes, dts)]

    def launch_k4(lib, bufs):
        counter.zero_()
        lib.call("mk_start_chained", ms, pxs, pys, seeds, n, S, cap, *bufs, counter=counter)

    def launch_k2(lib, i, bufs):
        st, rng, cap2 = k2_args[i]
        lib.call("mk_resume", ms, st, rng, st.shape[1], cap2, *bufs)

    def k2_buffers(i):
        st = k2_args[i][0]
        return [torch.empty_like(st), torch.empty(st.shape[1], dtype=torch.int32, device=dev)]

    rays = {kind: pwk.ray_set(kind, cs, 1 << 20, dev) for kind in ("camera", "random")}

    def launch_walk(lib, kind, bufs):
        o, d = rays[kind]
        lib.call("walk_isolate", ms, 32, 1, 1, 1, o, d, o.shape[1], 128, *bufs, None)

    def walk_buffers():
        return [torch.empty(1 << 20, dtype=torch.float32, device=dev) for _ in range(2)]

    # first launches: every library's outputs against the parent's
    outs = {}
    for lib in libs:
        bufs = k4_buffers()
        launch_k4(lib, bufs)
        o = {"K4": bufs}
        for i in range(len(k2_args)):
            o[f"K2 #{i}"] = k2_buffers(i)
            launch_k2(lib, i, o[f"K2 #{i}"])
        for kind in rays:
            o[f"K10b {kind}"] = walk_buffers()
            launch_walk(lib, kind, o[f"K10b {kind}"])
        torch.cuda.synchronize()
        outs[lib.name] = o
    ok = True
    for lib in libs[1:]:
        for key, got in outs[lib.name].items():
            same = bit_equal(got, outs["parent"][key])
            ok &= same
            print(f"{lib.name} {key}: {'bit-equal to' if same else 'DIFFERS from'} the parent's outputs")
    pool, _, chain_out = outs["parent"]["K4"]
    ratios = mk.warp_iterations(mk.chained_segs(pool, chain_out, S))
    ratios["sum_max/sum_mean"] = ratios["sum_max"] / ratios["sum_mean"]
    ratios["max_sum/sum_mean"] = ratios["max_sum"] / ratios["sum_mean"]
    result["warp_iterations"] = ratios
    print("warp-bounces a warp in the chunk (mean over warps of 32 consecutive lanes): "
          + ", ".join(f"{k} {v:.4f}" for k, v in ratios.items()), flush=True)
    del outs

    # timing: the libraries in turn, each launch between two events
    def event_ms(fn, prep=None):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if prep is None:
            prep = lambda: None
        torch.cuda.synchronize()
        a.record()
        fn(prep())
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    cases = {"K4": (lambda lib: k4_buffers(), launch_k4)}
    for i, (st, _, cap2) in enumerate(k2_args):
        cases[f"K2 #{i} ({st.shape[1]} lanes, cap {cap2})"] = (
            lambda lib, i=i: k2_buffers(i), lambda lib, bufs, i=i: launch_k2(lib, i, bufs))
    for kind in rays:
        cases[f"K10b {kind}"] = (lambda lib: walk_buffers(),
                                 lambda lib, bufs, kind=kind: launch_walk(lib, kind, bufs))
    times = {c: {lib.name: [] for lib in libs} for c in cases}
    held = {(c, lib.name): make(lib) for c, (make, _) in cases.items() for lib in libs}
    for rep in range(args.reps + 1):  # round 0 warms up
        for c, (make, launch) in cases.items():
            for lib in libs:
                t = event_ms(lambda bufs: launch(lib, bufs), lambda: held[(c, lib.name)])
                if rep:
                    times[c][lib.name].append(t)
    result["times"] = {}
    for c, by_lib in times.items():
        base = summary(by_lib["parent"])
        result["times"][c] = {}
        for name, ts in by_lib.items():
            sm = summary(ts)
            sm["ratio_min"] = sm["min_ms"] / base["min_ms"]
            sm["ratio_median"] = sm["median_ms"] / base["median_ms"]
            result["times"][c][name] = sm
            print(f"{c:34s} {name:14s} min {sm['min_ms']:9.4f} ms, median {sm['median_ms']:9.4f} ms "
                  f"(x{sm['ratio_min']:.4f} / x{sm['ratio_median']:.4f} the parent's)", flush=True)

    # SASS: the K4/K2 kernels' control instructions, the K10b walk's loops
    args.sass.mkdir(parents=True, exist_ok=True)
    result["sass"] = {}
    for lib in libs:
        every = sass_functions("", lib.path)
        for k, parts in KERNELS.items():
            found = {f: v for f, v in every.items() if any(p in f for p in parts)}
            for fname, (code, loops, text) in found.items():
                (args.sass / f"{lib.name}_{k}.sass").write_text(text)
                counts = op_counts(code)
                ctl = {o: sum(v for op, v in counts.items() if op.startswith(o)) for o in SASS_OPS}
                entry = {"instructions": len(code), "control": ctl}
                if k == "K10b":
                    entry["loops"] = sorted(
                        ({"start": s0, "end": e0, "ops": op_counts(code[s0:e0 + 1])}
                         for s0, e0 in loops if e0 - s0 < 200), key=lambda lp: lp["end"] - lp["start"])
                result["sass"][f"{lib.name} {k}"] = entry
                print(f"SASS {lib.name} {k}: {len(code)} instructions; " + ", ".join(
                    f"{o} {v}" for o, v in ctl.items()))
                for lp in entry.get("loops", []):
                    if any(op.startswith("LDG") for op in lp["ops"]):  # the walk's row loads
                        print(f"    loop [{lp['start']}, {lp['end']}] {lp['end'] - lp['start'] + 1} "
                              f"instructions: {lp['ops']}")
    if args.json:
        Path(args.json).write_text(json.dumps(result, indent=1, default=str))
    if not ok:
        print("FAIL: a library's outputs differ from the parent's", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
