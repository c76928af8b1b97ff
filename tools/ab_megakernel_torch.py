"""A/B of hand-written kernels between the package's csrc/ and another build,
on one CUDA card: the megakernel's chained camera launch (K4) and resume
launch (K2) and the walk they share, and (``--kernels``) the reconstruction
stencil (K3), the trace-row walk (K6), the camera launch (K1), the
single-launch render (K5), the lane-sorted K1/K2/K5 and the tile sort (K8),
the walker-body ablation (K10a) and the staged chase (K11a), and every
kernel's SASS against the parent's.

    python tools/ab_megakernel_torch.py PARENT_CSRC [--kernels megakernel,reconstruct,traverse,start,sorted,probes,sass]
                                        [--variants walk,loop,NAME=DIR]
                                        [--reps 10] [--json PATH] [--sass DIR]

PARENT_CSRC is a directory holding another commit's
``hijiki_tpu_torch/csrc`` files, inside the repository when a remote machine
runs the tool (the ignored ``build/`` is a good place):

    mkdir -p build/ab/parent
    git archive <commit> hijiki_tpu_torch/csrc | tar -x --strip-components=2 -C build/ab/parent

``--kernels`` (default ``megakernel``) picks the libraries' sources: the
megakernel group builds ``megakernel.cu`` and ``probe_walk.cu``, the
``reconstruct`` and ``traverse`` group ``reconstruct.cu`` and
``traverse.cu``, each with the headers of its tree (``utils.build.build``,
one nvcc per source, all libraries at once, never from the cache: its
ptxas report is wanted), loaded with ctypes and called at their C entry
points. ``--variants`` adds libraries built from mixed trees: ``walk`` (the
parent with the package's walk.cuh and row.cuh: the row step alone),
``loop`` (the package with the parent's walk.cuh: the persistent loop
alone), ``NAME=DIR`` (the csrc files in DIR). Every library's outputs must
equal the parent's bit for bit (int32 views). Times: CUDA events around
each call, the libraries in turn, ``--reps`` rounds after a warm-up; min
and median, and each library's ratio to the parent. Also printed: the
card's name and power limit; ptxas' registers and spill stores of each
kernel and its resident warps an SM; SASS counts (cuobjdump; the SASS is
written to ``--sass``, default ``build/ab_megakernel/sass``). Needs a CUDA
card and nvcc; imports only the port and chip_smoke's helpers.

The megakernel group replays the chained chunk of ``chip_smoke.py`` phase 6
(the meshbox + cbox spheres at 1024x1024, 8 sweeps, chain cap 8,
max_bounces 1000), recorded through the package's wrappers: its K4 launch
and its two K2 launches (capacities 2,097,152 and 524,288 lanes, caps 48
and 1000); and ``walk_isolate`` on 1024x1024 camera rays and 1M random rays
(32-column table, one thread a ray). A library whose ``mk_start_chained``
is persistent (it exports ``mk_occupancy``) takes a work counter for it,
zeroed before each launch. It prints the warp-iteration ratios of the chunk
(``mk.warp_iterations`` of K4's ``segs``) and each K4 and K2 kernel's count
of BSSY/BSYNC/WARPSYNC/VOTE/SHFL/ATOM instructions and the loops of K10b's
walk (instructions by opcode).

The reconstruct group replays K3 on the same chunk's 8 sweeps (radiance,
normals, offsets): a library whose K3 takes one sweep a launch runs 8
launches and 7 torch adds in the event window (the renderer's sum in sweep
order), one that takes a chunk one launch (and, beside it, the same
library one sweep a launch with the adds: what the chunk launch saves);
and one 1024x1024 sweep, 20 launches back to back in a stream. Its SASS
count: the instructions of the loop that holds the most taps over its taps
(one MUFU.EX2 a tap's expf). The traverse group replays K6 on five calls of
one 1024x1024 sync sweep recorded through the package's wrapper (bounce
1's closest and shadow walks, the closest walks of bounces 9, 30 and 200),
with each call's count of walking rays and its bound (chip_smoke's); then
the whole sweep with the parent's and the package's K6 in turn (parent,
new, new, parent) under torch.profiler, K6's device time summed. Its SASS:
the walk loops.

The start group replays the unchained sweep's K1 launch and splits K5 on
the 1M-path frame: its time at caps 5, 12, 48 and 1000, the warp-bounces of
its paths (``mk.warp_iterations`` of the bounces K1 counts at cap 1000,
state channel 27) and its tail floor (K5 on the frame's 32 paths of the
most bounces alone, one warp: the longest chain, which no schedule
shortens; K5 less the floor is the bulk). The sorted group replays the
sweep's K1 and K2 calls sorted and unsorted, K5 sorted and unsorted to
1000, and K8 on 1,024 tiles x 31 channels and on its keys alone (0
channels), K8_BURST launches an event window. A library whose K1 or K5
entry takes no work counter (one path a thread) is called without one.
Both print each kernel's registers, spill stores, local bytes and
resident warps an SM, and each kernel's SASS instruction count and
whether its code is the parent's. ``PATH_VARIANTS`` rewrite a staged copy
of a tree to take one part back.

The probes group builds ``probe_walk.cu`` and ``probe_latency.cu`` of each
tree and runs K10a (every variant of ``ablate_walker.VARIANTS``, G = 1 and
32, 1M random rays over the meshbox + spheres rows, 16 steps, 128 threads a
block) and staged_chase (``PROBE_STAGED``: chase, indep, multi G = 4 with
spec; 32,768 warps, 8 steps, on chip_smoke's (k) table, one warp a block);
it prints each timed kernel's registers, spill stores and warps an SM, the
times, and the SASS memory instructions (``sass_counts``: LDG.E.128 against
narrower LDGs, LDGSTS against the bulk copy UBLKCP, STG.E.128 against
narrower stores), and requires every K10a instantiation of the package's
tree to load its rows with 128-bit loads only
(``ablate_walker.check_row_loads``). The sass group builds every
``csrc/*.cu`` of both trees and compares each kernel function of the
parent with the package's of the same mangled name (registers, spill
stores, SASS code with its labels unnumbered), by family: K1-K8, K9, K10a,
K10b, K11a, K11b.
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



def mangled(kernel: str, *older: str, targs: str = "ILi0ELb0ELb0E") -> tuple:
    """The forms of a megakernel's name, as (kernel, mangled template
    arguments) pairs (``build.ptxas_of``'s): the instantiation ``targs`` of
    this tree's template on the trace-row format, the shadow table and the
    occlusion cache (default the classic rows without either, <0, false,
    false>; its <0, false> in a tree from before the cache), the plain
    function of a tree from before the formats, and ``older`` mangled
    template arguments (a template on kSort)."""
    forms = [(kernel, targs)]
    if targs == "ILi0ELb0ELb0E":
        forms += [(kernel, "ILi0ELb0E"), (kernel, "")]
    return tuple(forms) + tuple((kernel, t) for t in older)


def frags(forms) -> tuple:
    """The parts of a mangled name that ``forms`` (kernel, template
    arguments) name, as ``build.ptxas_of`` matches them."""
    return tuple(f"{len(k)}{k}{t}E" for k, t in forms)


def ptxas_first(report: str, forms) -> tuple:
    """(registers, spill-store bytes) of the first of ``forms`` that
    ptxas' ``report`` has (``build.ptxas_of``); KeyError if none."""
    from hijiki_tpu_torch.utils import build

    for kernel, targs in forms:
        try:
            return build.ptxas_of(report, kernel, targs)
        except KeyError:
            continue
    raise KeyError(f"ptxas reported none of {frags(forms)}")


# the kernels reported, by their name's forms
KERNELS = {"K4": mangled("mk_start_chained_kernel"),
           "K2": mangled("mk_resume_kernel", "ILb0"),  # or a template on kSort
           "K10b": (("walk_isolate_kernel", "ILi32ELb1ELi1E"),)}
SASS_OPS = ("BSSY", "BSYNC", "WARPSYNC", "VOTE", "SHFL", "ATOM", "RED")


MEGA_FILES = ("megakernel.cu", "probe_walk.cu")
K36_FILES = ("reconstruct.cu", "traverse.cu")


def stage(name: str, csrc: Path, walk_from: Path | None = None, files=MEGA_FILES) -> Path:
    """A directory holding what the library ``name`` builds from: csrc's
    ``files`` and headers (walk.cuh and row.cuh taken from ``walk_from`` if
    given), its cached build removed."""
    from hijiki_tpu_torch.utils import build

    out = build.BUILD_ROOT.parent / "ab_megakernel" / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for f in [*(csrc / f for f in files), *csrc.glob("*.cuh")]:
        shutil.copy(f, out / f.name)
    if walk_from is not None:
        for h in ("walk.cuh", "row.cuh"):
            if (walk_from / h).exists():
                shutil.copy(walk_from / h, out / h)
    shutil.rmtree(build.BUILD_ROOT / build.cache_key(out), ignore_errors=True)
    return out


def warps_from_registers(regs: int, threads: int = 128) -> int:
    """Resident warps an SM of a kernel of ``regs`` registers a thread in
    blocks of ``threads`` (65,536 registers an SM, allocated 256 a warp; at
    most 32 blocks and 64 warps an SM)."""
    per_warp = -(-regs * 32 // 256) * 256
    blocks = min(65536 // (per_warp * threads // 32), 32, 64 * 32 // threads)
    return blocks * threads // 32


def old_scene(tree: Path) -> int | None:
    """How much of mk._scene_args the C entries of ``tree`` take after the
    rows and the constants: its first 10 in the builds before the packed
    formats (no packed format, payload rows, boxes or shadow table), its
    first 15 in those before the occlusion cache (no cache or skip-all
    word); None: all of it."""
    text = (tree / "walk.cuh").read_text()
    if "shadow_rows" not in text:
        return 10
    return 15 if "skip_all" not in text else None


def entry_argtypes(fn: str, old: int | None) -> list:
    """build.SIGNATURES[fn], with the scene block of an ``old_scene``."""
    from hijiki_tpu_torch.utils import build

    argtypes = list(build.SIGNATURES[fn])
    if old and argtypes[:len(build._SCENE)] == build._SCENE:
        del argtypes[2 + old:len(build._SCENE)]
    return argtypes


def scene_args(ms, old: int | None, rows=None) -> tuple:
    """The scene block of a call: rows (``ms.rows``, or ``rows``),
    constants, mk._scene_args (its first ``old`` for an old library)."""
    from hijiki_tpu_torch.ops import megakernel as mk

    ints = mk._scene_args(ms)
    return ((ms.rows if rows is None else rows).data_ptr(), ms.consts.data_ptr(),
            *(ints[:old] if old else ints))


class Lib:
    """One built kernel library and its C entries."""

    def __init__(self, name: str, path: Path, report: str, tree: Path):
        self.name, self.path, self.report, self.tree = name, path, report, tree
        self.cdll = ctypes.CDLL(str(path))
        self.persistent = hasattr(self.cdll, "mk_occupancy")
        self.old = old_scene(tree)
        for fn in ["mk_start_chained", "mk_resume", "walk_isolate"] + ["mk_occupancy"] * self.persistent:
            argtypes = entry_argtypes(fn, self.old)
            if fn == "mk_start_chained" and not self.persistent:
                del argtypes[-2]  # a K4 that is not persistent takes no work counter
            getattr(self.cdll, fn).argtypes = argtypes
            getattr(self.cdll, fn).restype = ctypes.c_int

    def call(self, fn: str, ms, *args, counter=None, rows=None):
        import torch

        ptr = lambda a: a.data_ptr() if torch.is_tensor(a) else a
        tail = [counter.data_ptr()] if (self.persistent and fn == "mk_start_chained") else []
        rc = getattr(self.cdll, fn)(*scene_args(ms, self.old, rows), *map(ptr, args), *tail,
                                    torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} {fn}: CUDA error {rc}")

    def kernels(self) -> dict:
        """{K4/K2/K10b: (registers, spill store bytes, resident warps an SM,
        K4's persistent blocks or None)}."""
        from hijiki_tpu_torch.ops import megakernel as mk

        out = {}
        for k, forms in KERNELS.items():
            try:
                regs, spill = ptxas_first(self.report, forms)
            except KeyError as e:
                raise RuntimeError(f"{self.name}: {k}: {e}") from None
            warps, blocks = warps_from_registers(regs), None
            if self.persistent and k != "K10b":
                occ = mk.occupancy({"K4": "mk_start_chained", "K2": "mk_resume"}[k], self.cdll)
                warps = occ["warps_per_sm"]
                blocks = occ["blocks_per_sm"] * occ["sms"] if k == "K4" else None
            out[k] = (regs, spill, warps, blocks)
        return out


def sweep_frame(sched, W: int, H: int, dev) -> tuple:
    """(px, py, seeds as int32 bits, the sample offset) of one W x H sweep
    of the scheduler's ``sched``, block size 128 (chip_smoke's frames)."""
    import numpy as np
    import torch

    from hijiki_tpu_torch.ops.rng import to_bits
    from hijiki_tpu_torch.render.blocks import per_pixel_seeds_device

    so = np.asarray(sched.sample_offset, np.float32)
    yy = torch.arange(H, dtype=torch.float32, device=dev).view(-1, 1).expand(H, W)
    xx = torch.arange(W, dtype=torch.float32, device=dev).view(1, -1).expand(H, W)
    return ((xx + float(so[0])).reshape(-1).contiguous(), (yy + float(so[1])).reshape(-1).contiguous(),
            to_bits(per_pixel_seeds_device(W, H, 128, sched.block_seeds, dev).reshape(-1)), so)


def summary(ms_list) -> dict:
    return {"min_ms": min(ms_list), "median_ms": statistics.median(ms_list), "n": len(ms_list)}


def build_libraries(parent: Path, variants: str, files, make_lib) -> list:
    """Stage and build the parent's, the package's and each variant's
    library from ``files`` (all at once); returns (make_lib(name, path,
    ptxas report, staged tree), build seconds) of each, the parent's first."""
    from hijiki_tpu_torch.utils import build

    trees = {"parent": stage("parent", parent, files=files), "new": stage("new", build.CSRC, files=files)}
    for v in filter(None, variants.split(",")):
        if v in ("walk", "loop") and files != MEGA_FILES or v in PATH_VARIANTS and files != PATH_FILES:
            continue  # another group's variant
        if v == "walk":
            trees[v] = stage(v, parent, walk_from=build.CSRC, files=files)
        elif v == "loop":
            trees[v] = stage(v, build.CSRC, walk_from=parent, files=files)
        elif v in PATH_VARIANTS:
            base, edits, _ = PATH_VARIANTS[v]
            trees[v] = rewrite(stage(v, parent if base == "parent" else build.CSRC, files=files), edits)
        elif "=" in v:
            name, tree = v.split("=", 1)
            trees[name] = stage(name, Path(tree).resolve(), files=files)
        else:
            raise SystemExit(f"unknown variant {v!r} for {files}")
    keys = {name: build.cache_key(tree) for name, tree in trees.items()}
    unique = {}  # trees of equal sources build once (two builds of one key would collide)
    for name, key in keys.items():
        unique.setdefault(key, trees[name])
    with ThreadPoolExecutor(len(unique)) as ex:
        by_key = dict(zip(unique, ex.map(build.build, unique.values())))
    built = {name: by_key[key] for name, key in keys.items()}
    return [(make_lib(name, path, report, trees[name]), secs)
            for name, (path, secs, report) in built.items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path, help="a directory holding the parent's csrc/ files")
    ap.add_argument("--kernels", default="megakernel",
                    help="comma-separated groups: megakernel, reconstruct, traverse, start, "
                         "sorted, probes, sass")
    ap.add_argument("--variants", default="",
                    help="comma-separated: walk, loop (megakernel group), the names of "
                         "PATH_VARIANTS (start and sorted groups), NAME=DIR")
    ap.add_argument("--reps", type=int, default=10, help="timed launches a library (>= 10)")
    ap.add_argument("--json", help="write the results here")
    ap.add_argument("--sass", type=Path, default=Path(HERE).parent / "build" / "ab_megakernel" / "sass",
                    help="write the kernels' SASS here")
    args = ap.parse_args(argv)
    groups = set(filter(None, args.kernels.split(",")))
    if not groups or groups - {"megakernel", "reconstruct", "traverse", "start", "sorted", "probes",
                               "sass"}:
        ap.error(f"--kernels: unknown group in {args.kernels!r}")

    import torch

    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 2
    from hijiki_tpu_torch.probes import card

    print(card(), flush=True)
    parent = args.parent.resolve()
    need = (MEGA_FILES if "megakernel" in groups else ()) + (
        K36_FILES if groups & {"reconstruct", "traverse"} else ()) + (
        PATH_FILES if groups & {"start", "sorted"} else ()) + (
        PROBE_FILES if "probes" in groups else ())
    missing = [f for f in need if not (parent / f).exists()]
    if missing:
        print(f"error: {parent} holds no {', '.join(missing)}", file=sys.stderr)
        return 2
    result, ok = {"card": card()}, True
    if "megakernel" in groups:
        part, good = mega_ab(args, parent)
        result.update(part)
        ok &= good
    if groups & {"reconstruct", "traverse"}:
        part, good = k36_ab(args, parent, groups)
        result["k3_k6"] = part
        ok &= good
    if groups & {"start", "sorted"}:
        part, good = paths_ab(args, parent, groups)
        result["paths"] = part
        ok &= good
    if "probes" in groups:
        part, good = probes_ab(args, parent)
        result["probes"] = part
        ok &= good
    if "sass" in groups:
        result["sass"], _ = sass_ab(args, parent)
    if args.json:
        Path(args.json).write_text(json.dumps(result, indent=1, default=str))
    if not ok:
        print("FAIL: a library's outputs differ from the parent's, or K10a's row loads are "
              "narrowed (above)", flush=True)
        return 1
    return 0


def mega_ab(args, parent: Path) -> tuple:
    """The megakernel group (K4, K2, K10b); returns (its results, whether
    every library's outputs equal the parent's)."""
    import numpy as np
    import torch

    from hijiki_tpu_torch.ops import megakernel as mk
    from hijiki_tpu_torch.probes import card, op_counts, sass_functions
    from hijiki_tpu_torch.probes import walk_probe as pwk
    from hijiki_tpu_torch.render.renderer import RenderConfig, Renderer, render_sweeps_chained
    from hijiki_tpu_torch.scene.compile import compile_scene
    from hijiki_tpu_torch.scene.obj import load_obj_scene

    pairs = build_libraries(parent, args.variants, MEGA_FILES,
                            lambda name, path, report, tree: Lib(name, path, report, tree))
    libs = [lib for lib, _ in pairs]
    built = {lib.name: (lib.path, secs, lib.report) for lib, secs in pairs}
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
    cs = compile_scene(scene, shadow_vis_boxes=False)  # the parent's configuration
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
        for k, forms in KERNELS.items():
            found = {f: v for f, v in every.items() if any(p in f for p in frags(forms))}
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
    del held, rays
    part, good = tables_ab(args, libs)
    result["k10b_tables"] = part
    ok &= good
    part, good = formats_ab(args, libs)
    result["formats"] = part
    ok &= good
    return result, ok


def alternate(libs, cases, run, reps: int) -> dict:
    """Time each case's ``run(lib, case)`` on every library, the libraries
    in turn (the order reversed every other round), each launch between two
    CUDA events, after a warm-up round: {case: {library: [ms, ...]}}."""
    import torch

    times = {c: {lib.name: [] for lib in libs} for c in cases}
    for rep in range(reps + 1):  # round 0 warms up
        for c in cases:
            for lib in (libs if rep % 2 else libs[::-1]):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                a.record()
                run(lib, c)
                b.record()
                b.synchronize()
                if rep:
                    times[c][lib.name].append(a.elapsed_time(b))
    return times


def report_times(times: dict, width: int = 60) -> dict:
    """Each case's min and median per library and their ratios to the
    parent's, printed; returns them."""
    out = {}
    for c, by_lib in times.items():
        base = summary(by_lib["parent"])
        out[c] = {}
        for name, ts in by_lib.items():
            sm = summary(ts)
            sm["ratio_min"] = sm["min_ms"] / base["min_ms"]
            sm["ratio_median"] = sm["median_ms"] / base["median_ms"]
            out[c][name] = sm
            print(f"{c:{width}s} {name:10s} min {sm['min_ms']:9.4f} ms, median {sm['median_ms']:9.4f} "
                  f"ms (x{sm['ratio_min']:.4f} / x{sm['ratio_median']:.4f} the parent's)", flush=True)
    return out


def tables_ab(args, libs) -> tuple:
    """K10b on every table of ``walk_probe.TABLES`` (w32, w16, slim, pack3,
    pack4, pack12), with and without the prim test, G = 1 and 32, on the
    1024x1024 camera rays (``walk_probe``'s widths frame): t and rows
    visited of every library bit-equal to the parent's, then timed in turns.
    Returns (its results, whether every output equals the parent's)."""
    import torch

    from hijiki_tpu_torch.probes import walk_probe as pwk

    dev = torch.device("cuda")
    tables, cs = pwk.load_tables(pwk.SCENE, dev, pwk.TABLES)
    o, d = pwk.ray_set("camera", cs, 1 << 20, dev)
    n = o.shape[1]
    cases = {f"K10b {t} {'test' if test else 'notest'} G={g}": (t, test, g)
             for t in pwk.TABLES for test in (True, False) for g in (1, 32)}
    outs = {(lib.name, c): [torch.empty(n, dtype=torch.float32, device=dev) for _ in range(2)]
            for lib in libs for c in cases}

    def run(lib, c):
        t, test, g = cases[c]
        ms, rows = tables[t]
        lib.call("walk_isolate", ms, rows.shape[1], int(test), g, 1, o, d, n, 128,
                 *outs[(lib.name, c)], None, rows=rows)

    ok, result = True, {"checks": {}}
    for c in cases:
        for lib in libs:
            run(lib, c)
        torch.cuda.synchronize()
        for lib in libs[1:]:
            same = bit_equal(outs[(lib.name, c)], outs[("parent", c)])
            ok &= same
            result["checks"][f"{lib.name} {c}"] = same
            if not same:
                print(f"{lib.name} {c}: DIFFERS from the parent's t or rows visited", flush=True)
        result["checks"][f"rows per ray {c}"] = float(outs[("parent", c)][1].double().mean())
    print(f"K10b on {len(cases)} cases (tables x test/notest x G): "
          f"{'every library bit-equal to the parent' if ok else 'OUTPUTS DIFFER'}", flush=True)
    result["times"] = report_times(alternate(libs, cases, run, args.reps), 34)
    return result, ok


def formats_ab(args, libs) -> tuple:
    """K1, K2, K4, K5 and the sorted K1/K2/K5 on every format of
    ``mk.KERNEL_FORMATS`` (the meshbox + spheres compiled with its
    packed_leaf and the shadow-visibility boxes, launched with its shadow
    table and occlusion cache), and (p)'s chained chunk (the meshbox split
    4-to-1 twice, 100,384 triangles, compiled PACKED4 by the default
    auto): the calls of chip_smoke's phase 6 recorded through the package
    (the chained chunk's K4 and two K2, the unchained sweep's K1 and three
    K2, K5 on the sweep's frame to 1000), the sorted forms on the sweep's K1
    and K2 calls and K5's; every output of every library bit-equal to the
    parent's, then each call timed in turns. Returns (its results, whether
    every output equals the parent's)."""
    import numpy as np
    import torch

    from hijiki_tpu_torch.ops import megakernel as mk
    from hijiki_tpu_torch.probes import walk_probe as pwk
    from hijiki_tpu_torch.render.renderer import RenderConfig, Renderer
    from hijiki_tpu_torch.scene.bigscene import split_scene
    from hijiki_tpu_torch.scene.compile import compile_scene
    from hijiki_tpu_torch.scene.obj import load_obj_scene

    plibs = [PathLib(lib.name, lib.path, lib.report, lib.tree) for lib in libs]
    dev = torch.device("cuda")
    W = H = 1024
    scene = load_obj_scene(pwk.SCENE)
    scene.put_cbox_spheres()
    cfg = RenderConfig(width=W, height=H, spp=8, max_bounces=1000, block_size=128, use_bvh=True,
                       driver="mega")
    compiled = {leaf: compile_scene(scene, packed_leaf=leaf) for leaf in (0, 1, 3, 4, 12)}
    compiled["p"] = compile_scene(split_scene(scene, 2))
    sched = Renderer(compiled[0], cfg, device="cuda").scheduler
    frames = [sweep_frame(sched.sweep(cfg.spp + 1 + s), W, H, dev) for s in range(mk.CHAIN_SWEEPS_CUDA)]
    cpx, cpy, cseeds = (torch.stack([f[i] for f in frames]) for i in range(3))
    upx, upy, useeds, _ = sweep_frame(sched.sweep(cfg.spp + 1 + mk.CHAIN_SWEEPS_CUDA), W, H, dev)
    n = upx.numel()
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    configs = {f: (compiled[leaf], dict(shadow_tbl=sh, shadow_cache=cache))
               for f, (leaf, sh, cache) in mk.KERNEL_FORMATS.items()}
    configs["(p) packed4"] = (compiled["p"], {})
    real = ["mk_start", "mk_resume", "mk_start_chained"]
    result, ok = {"checks": {}, "times": {}}, True

    def outs_of(entry, a):
        """(C entry's arguments before its outputs, its fresh outputs)"""
        if entry == "mk_start_chained":
            pxs, pys, sds, cap = a
            S, m = pxs.shape
            shapes = ((mk.N_STATE, S * m), (S * m,), (mk.CHAIN_OUT_CH, S * m))
            return (pxs, pys, sds, m, S, cap), [
                torch.zeros(sh, dtype=dt, device=dev)
                for sh, dt in zip(shapes, (torch.float32, torch.int32, torch.float32))]
        ch = len(mk._TILE_CH) if entry.startswith("mk_tiles") else mk.N_STATE
        lanes = a[-2].numel()
        outs = [torch.empty((ch, lanes), dtype=torch.float32, device=dev),
                torch.empty(lanes, dtype=torch.int32, device=dev)]
        return (*a[:-1], lanes, a[-1]), outs + ([None] if entry.endswith("_sorted") else [])

    for label, (cs_f, opts) in configs.items():
        ms_f = mk.launch_scene(mk.mega_scene(cs_f, W, H, dev), **opts)
        calls = record_calls(mk, real, lambda: mk.render_waves_chained(
            ms_f, cpx, cpy, cseeds, max_bounces=1000, **opts))
        if not label.startswith("(p)"):
            sweep = record_calls(mk, real, lambda: mk.render_waves(
                ms_f, upx, upy, useeds, max_bounces=1000, **opts))
            calls += sweep + [("mk_tiles", (upx, upy, useeds, 1000))]
            calls += [(name + "_sorted", a) for name, a in sweep] + [
                ("mk_tiles_sorted", (upx, upy, useeds, 1000))]
        cases, seen = {}, {}
        for entry, a in calls:
            seen[entry] = seen.get(entry, 0) + 1
            lanes = "x".join(str(x) for x in a[-2].shape)
            cases[f"{label} {entry} #{seen[entry]} ({lanes} lanes, cap {a[-1]})"] = (entry, a)
        held = {}

        def run(lib, c):
            entry, _ = cases[c]
            cargs, outs = held[(lib.name, c)]
            lib.call(entry, ms_f, *cargs, *outs, counter=counter)

        for c, (entry, a) in cases.items():
            for lib in plibs:
                held[(lib.name, c)] = outs_of(entry, a)
                run(lib, c)
            torch.cuda.synchronize()
            want = [o for o in held[("parent", c)][1] if o is not None]
            for lib in plibs[1:]:
                same = bit_equal([o for o in held[(lib.name, c)][1] if o is not None], want)
                ok &= same
                result["checks"][f"{lib.name} {c}"] = same
                if not same:
                    print(f"{lib.name} {c}: DIFFERS from the parent's outputs", flush=True)
        print(f"{label}: {len(cases)} calls, " + ("every library bit-equal to the parent"
              if all(result["checks"].get(f"{lib.name} {c}", True) for lib in plibs[1:] for c in cases)
              else "OUTPUTS DIFFER"), flush=True)
        result["times"].update(report_times(alternate(plibs, cases, run, args.reps)))
        del held, ms_f
        torch.cuda.empty_cache()
    return result, ok


# the K3/K6 kernels reported, by a part of their mangled names
K36_KERNELS = {"K3": ("reconstruct_kernel",), "K6": ("traverse_kernel",)}
# K6's recorded calls of one sync sweep: closest and shadow walk of bounce
# 1, then the closest walks of bounces 9, 30 and 200 (two calls a bounce)
K6_CALLS = (0, 1, 16, 58, 398)


class K36Lib:
    """One built K3 + K6 library and its C entries: a K3 that takes one
    sweep a launch (so_x, so_y) or a chunk (host offsets, S), and K6."""

    def __init__(self, name: str, path: Path, report: str, tree: Path):
        self.name, self.path, self.report = name, path, report
        self.cdll = ctypes.CDLL(str(path))
        self.chunk = "const float* offsets" in (tree / "reconstruct.cu").read_text()
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        k3 = [P, P, P, I, F, I, I, I, P, P] if self.chunk else [P, P, F, F, F, I, I, I, P, P]
        for fn, argtypes in (("reconstruct", k3), ("traverse", [P, I, P, P, P, P, I, I, I, P, P])):
            getattr(self.cdll, fn).argtypes = argtypes
            getattr(self.cdll, fn).restype = ctypes.c_int

    @staticmethod
    def _rc(what, rc):
        if rc != 0:
            raise RuntimeError(f"{what}: CUDA error {rc}")

    def k3(self, color, normal, offs, block, gauss, outs, chunk=True):
        """The (S, H, W, 3) sweeps' summed delta: one launch into outs[0]
        (a library that takes a chunk, unless ``chunk`` is False), or one
        launch a sweep into outs[s] and the renderer's torch adds."""
        import torch

        S, H, W = color.shape[:3]
        stream = torch.cuda.current_stream().cuda_stream
        if self.chunk and chunk:
            self._rc(f"{self.name} K3", self.cdll.reconstruct(
                color.data_ptr(), normal.data_ptr(), offs.ctypes.data, S, gauss, H, W, block,
                outs[0].data_ptr(), stream))
            return outs[0]
        delta = None
        for s in range(S):
            so = (offs[s:s + 1].ctypes.data, 1) if self.chunk else (float(offs[s, 0]), float(offs[s, 1]))
            self._rc(f"{self.name} K3", self.cdll.reconstruct(
                color[s].data_ptr(), normal[s].data_ptr(), *so, gauss, H, W, block,
                outs[s].data_ptr(), stream))
            delta = outs[s] if delta is None else delta + outs[s]
        return delta

    def k6(self, args, mode, out):
        """K6 on the recorded call ``args`` into ``out``."""
        import torch

        rows, o, d, tmin, tmax = args
        self._rc(f"{self.name} K6", self.cdll.traverse(
            rows.data_ptr(), rows.shape[0], o.data_ptr(), d.data_ptr(), tmin.data_ptr(),
            tmax.data_ptr(), o.shape[0], int(mode.get("any_hit", False)),
            int(mode.get("inclusive", False)), out.data_ptr(), torch.cuda.current_stream().cuda_stream))
        return out

    def occupancy(self) -> dict:
        """{kernel: resident warps an SM} from the library's occupancy
        entries where it has them."""
        out = (ctypes.c_int * 5)()
        ptr = ctypes.cast(out, ctypes.c_void_p)
        res = {}
        for fn, k in (("reconstruct_occupancy", "reconstruct_kernel"),
                      ("traverse_occupancy", "traverse_kernel")):
            if not hasattr(self.cdll, fn):
                continue
            getattr(self.cdll, fn).argtypes = [ctypes.c_void_p]
            self._rc(fn, getattr(self.cdll, fn)(ptr))
            res[k] = out[1] * out[2] // 32
        return res


def k36_ab(args, parent: Path, groups) -> tuple:
    """The reconstruct and traverse groups (K3, K6); returns (their results,
    whether every library's outputs equal the parent's)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import bound, k6_bytes_ops
    from hijiki_tpu_torch.ops import megakernel as mk
    from hijiki_tpu_torch.ops import pallas_traverse as pt
    from hijiki_tpu_torch.ops.camera import camera_rays
    from hijiki_tpu_torch.ops.integrate import integrate
    from hijiki_tpu_torch.ops.rng import from_bits, seed_rng
    from hijiki_tpu_torch.probes import op_counts, sass_functions
    from hijiki_tpu_torch.probes import walk_probe as pwk
    from hijiki_tpu_torch.render.renderer import RenderConfig, Renderer
    from hijiki_tpu_torch.scene.compile import compile_scene, to_device
    from hijiki_tpu_torch.scene.obj import load_obj_scene
    from hijiki_tpu_torch.utils import build

    with ThreadPoolExecutor(1) as ex:  # the package's own build (to record the calls) meanwhile
        pkg = ex.submit(build.build)
        pairs = build_libraries(parent, args.variants, K36_FILES, K36Lib)
        pkg.result()
    libs = [lib for lib, _ in pairs]
    result = {"libraries": {}, "times": {}, "sass": {}, "calls": []}
    print("library: registers, spill stores, resident warps an SM of each K3/K6 kernel")
    for lib, secs in pairs:
        table = build.ptxas_table(lib.report)
        occ = lib.occupancy()
        ks = {}
        for n, (regs, spill) in table.items():
            k = next((p for parts in K36_KERNELS.values() for p in parts if p in n), None)
            if k:
                ks[n] = {"kernel": k, "registers": regs, "spill_bytes": spill,
                         "warps_per_sm": occ.get(k, warps_from_registers(
                             regs, 256 if k == "reconstruct_kernel" else 128))}
        result["libraries"][lib.name] = {"build_s": secs, "chunk_k3": lib.chunk, "kernels": ks}
        print(f"  {lib.name:10s} built in {secs:.1f} s; " + "; ".join(
            f"{v['kernel']}{n[n.index('ILb'):n.index('ILb') + 10] if 'ILb' in n else ''} "
            f"{v['registers']} regs, {v['spill_bytes']} B spilled, {v['warps_per_sm']} warps/SM"
            for n, v in ks.items()), flush=True)

    dev = torch.device("cuda")
    scene = load_obj_scene(pwk.SCENE)
    scene.put_cbox_spheres()
    cs = compile_scene(scene, shadow_vis_boxes=False)  # the parent's configuration
    cfg = RenderConfig(width=1024, height=1024, spp=8, max_bounces=1000, block_size=128,
                       use_bvh=True, driver="mega")
    r = Renderer(cs, cfg, device="cuda")
    H = W = 1024
    frame_of = lambda sched: sweep_frame(sched, W, H, dev)

    ok = True
    cases = {}  # name -> (make outputs(lib), run(lib, outs) -> result to compare)
    if "reconstruct" in groups:
        frames = [frame_of(r.scheduler.sweep(cfg.spp + 1 + s)) for s in range(mk.CHAIN_SWEEPS_CUDA)]
        cpx, cpy, cseeds = (torch.stack([f[i] for f in frames]) for i in range(3))
        offs = np.stack([f[3] for f in frames]).astype(np.float32)
        t, nrm = mk.render_waves_chained(r.scene, cpx, cpy, cseeds, max_bounces=1000)[:2]
        S = offs.shape[0]
        color = t.reshape(S, H, W, 3).contiguous()
        normal = nrm.reshape(S, H, W, 3).contiguous()
        gauss = float(np.float32(-1.0 / (2.0 * cfg.reconstruction_stddev ** 2)))
        k3_outs = lambda lib: [torch.empty((H, W, 4), device=dev) for _ in range(1 if lib.chunk else S)]
        cases[f"K3 chunk ({S} x {H}x{W}, block 128)"] = (
            k3_outs, lambda lib, outs: (lib.k3(color, normal, offs, 128, gauss, outs),))
        cases[f"K3 chunk, one launch a sweep + {S - 1} adds"] = (
            lambda lib: [torch.empty((H, W, 4), device=dev) for _ in range(S)],
            lambda lib, outs: (lib.k3(color, normal, offs, 128, gauss, outs, chunk=False),))
        one = (color[:1], normal[:1], offs[:1])
        reps = 20

        def k3_stream(lib, outs):
            for _ in range(reps):
                got = lib.k3(*one, 128, gauss, outs)
            return (got,)

        cases[f"K3 one sweep ({H}x{W}), per launch of {reps} back to back"] = (
            lambda lib: [torch.empty((H, W, 4), device=dev)], k3_stream)
    if "traverse" in groups:
        csd = to_device(cs, dev)
        kpx, kpy, kseeds, _ = frame_of(r.scheduler.sweep(cfg.spp + 21))
        ko, kd, ktmin, ktmax = camera_rays(csd.cam_position, csd.cam_rotation, csd.cam_fov,
                                           torch.stack([kpx, kpy], -1), (W, H))
        real_traverse, recorded, count = pt.traverse, [], [0]

        def traverse_recorded(rows, o, d, tmin, tmax, **mode):
            if count[0] in K6_CALLS:
                recorded.append((count[0], (rows, o.clone(), d.clone(), tmin.clone(), tmax.clone()),
                                 mode))
            count[0] += 1
            return real_traverse(rows, o, d, tmin, tmax, **mode)

        pt.traverse = traverse_recorded
        try:
            sweep = integrate(csd, ko, kd, ktmin, ktmax, seed_rng(from_bits(kseeds)), max_bounces=1000)
        finally:
            pt.traverse = real_traverse
        if [c[0] for c in recorded] != list(K6_CALLS):
            raise SystemExit(f"the sync sweep made {count[0]} K6 calls ({sweep.iterations} bounces): "
                             f"too few to record calls {K6_CALLS}")
        for idx, a, mode in recorded:
            kind = "closest" if not mode.get("any_hit") else (
                "inclusive any-hit" if mode.get("inclusive") else "any-hit")
            walking = int((a[4] >= a[3]).sum())
            nb, ops = k6_bytes_ops(a, real_traverse(*a, **mode))
            b_ms, b_by = bound(nb, ops)
            label = f"K6 call {idx} ({kind}, bounce {idx // 2 + 1}, {walking} of {a[1].shape[0]} walking)"
            result["calls"].append({"call": idx, "mode": kind, "walking": walking,
                                    "bound_ms": b_ms, "bound_by": b_by})
            print(f"{label}: bound {b_ms:.4f} ms ({b_by})", flush=True)
            n = a[1].shape[0]
            cases[label] = (lambda lib, n=n: [torch.empty((pt.OUT_CH, n), device=dev)],
                            lambda lib, outs, a=a, mode=mode: (lib.k6(a, mode, outs[0]),))

    # first calls: every library's outputs against the parent's
    for c, (make, run) in cases.items():
        want = None
        for lib in libs:
            got = [x.clone() for x in run(lib, make(lib))]
            torch.cuda.synchronize()
            if want is None:
                want = got
                continue
            same = all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want))
            ok &= same
            print(f"{lib.name} {c}: {'bit-equal to' if same else 'DIFFERS from'} the parent's outputs",
                  flush=True)

    # timing: the libraries in turn, each call between two events
    def event_ms(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    held = {(c, lib.name): make(lib) for c, (make, _) in cases.items() for lib in libs}
    times = {c: {lib.name: [] for lib in libs} for c in cases}
    for rep in range(args.reps + 1):  # round 0 warms up
        for c, (_, run) in cases.items():
            for lib in (libs if rep % 2 else libs[::-1]):  # alternate the order
                t_ms = event_ms(lambda: run(lib, held[(c, lib.name)]))
                if rep:
                    times[c][lib.name].append(t_ms / (reps if c.startswith("K3 one") else 1))
    del held
    for c, by_lib in times.items():
        base = summary(by_lib["parent"])
        result["times"][c] = {}
        for name, ts in by_lib.items():
            sm = summary(ts)
            sm["ratio_min"] = sm["min_ms"] / base["min_ms"]
            sm["ratio_median"] = sm["median_ms"] / base["median_ms"]
            result["times"][c][name] = sm
            print(f"{c:64s} {name:10s} min {sm['min_ms']:9.4f} ms, median {sm['median_ms']:9.4f} ms "
                  f"(x{sm['ratio_min']:.4f} / x{sm['ratio_median']:.4f} the parent's)", flush=True)

    if "traverse" in groups:  # one whole sync sweep with each library's K6
        result["sweep"] = {}
        order = [libs[0], libs[1], libs[1], libs[0]]  # the parent's and the package's
        for lib in order:
            def traverse_lib(rows, o, d, tmin, tmax, lib=lib, **mode):
                out = torch.empty((pt.OUT_CH, o.shape[0]), device=dev)
                return lib.k6((rows, o, d, tmin, tmax), mode, out)

            pt.traverse = traverse_lib
            try:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    sw = integrate(csd, ko, kd, ktmin, ktmax, seed_rng(from_bits(kseeds)),
                                   max_bounces=1000)
                    torch.cuda.synchronize()
            finally:
                pt.traverse = real_traverse
            if not torch.equal(sw.state, sweep.state) or not torch.equal(sw.total, sweep.total):
                ok = False
                print(f"{lib.name}: the sync sweep with its K6 DIFFERS from the package's", flush=True)
            evs = list(prof.key_averages())
            dt = lambda e: getattr(e, "self_device_time_total", 0) / 1e3
            k6 = [e for e in evs if "traverse" in e.key]
            entry = {"k6_ms": sum(dt(e) for e in k6), "k6_kernels": sum(e.count for e in k6),
                     "device_ms": sum(dt(e) for e in evs), "bounces": sw.iterations}
            result["sweep"].setdefault(lib.name, []).append(entry)
            print(f"sync sweep with {lib.name}'s K6: K6 {entry['k6_ms']:.3f} ms of "
                  f"device time in {entry['k6_kernels']} kernels, all kernels {entry['device_ms']:.3f} "
                  f"ms, {sw.iterations} bounces", flush=True)

    # SASS: K3's sweep body a tap, K6's walk loops
    args.sass.mkdir(parents=True, exist_ok=True)
    for lib in libs:
        every = sass_functions("", lib.path)
        for k, parts in K36_KERNELS.items():
            for i, (fname, (code, loops, text)) in enumerate(every.items()):
                if not any(p in fname for p in parts):
                    continue
                short = next(p for p in parts if p in fname)
                (args.sass / f"{lib.name}_{short}_{i}.sass").write_text(text)
                ex2 = lambda ops: sum(1 for op, _ in ops if op.startswith("MUFU.EX2"))
                entry = {"instructions": len(code), "ex2": ex2(code)}
                if k == "K3":
                    # the loop holding the most expf (one MUFU.EX2 a tap; the
                    # shortest of those), else the function
                    s0, e0 = max(loops, key=lambda lp: (ex2(code[lp[0]:lp[1] + 1]), lp[0] - lp[1]),
                                 default=(0, len(code) - 1))
                    body = code[s0:e0 + 1]
                    if not ex2(body):
                        body = code
                    entry.update(body_instructions=len(body), body_taps=ex2(body),
                                 per_tap=len(body) / max(1, ex2(body)),
                                 body_ops=dict(sorted(op_counts(body).items(), key=lambda kv: -kv[1])[:16]))
                    print(f"SASS {lib.name} {short}: {len(code)} instructions; tap loop {len(body)} "
                          f"instructions over {ex2(body)} taps = {entry['per_tap']:.1f} a tap; "
                          f"top ops {entry['body_ops']}", flush=True)
                else:
                    entry["loops"] = [{"start": s0, "end": e0, "ops": op_counts(code[s0:e0 + 1])}
                                      for s0, e0 in loops if e0 - s0 < 300 and any(
                                          op.startswith("LDG") for op, _ in code[s0:e0 + 1])]
                    print(f"SASS {lib.name} {fname}: {len(code)} instructions", flush=True)
                    for lp in entry["loops"]:
                        print(f"    loop [{lp['start']}, {lp['end']}] {lp['end'] - lp['start'] + 1} "
                              f"instructions: {lp['ops']}", flush=True)
                result["sass"][f"{lib.name} {fname}"] = entry
    return result, ok


# ---- the start and sorted groups: K1, and the lane-sorted K1/K2/K5 (K7) ----

PATH_FILES = ("megakernel.cu", "sort.cu")
K8_BURST = 10  # K8's launches a timed window
# the kernels of the start and sorted groups, by a part of their mangled
# names (mangled(): the classic instantiation, or a parent's own kernels;
# older parents' K1/K2/K5 templates on kSort), and their mk_occupancy names
PATH_KERNELS = {"K1": (mangled("mk_start_kernel", "ILb0"), "mk_start"),
                "K1 sorted": (mangled("mk_start_sorted_kernel") + (("mk_start_kernel", "ILb1"),),
                              "mk_start_sorted"),
                "K2": (mangled("mk_resume_kernel", "ILb0"), "mk_resume"),
                "K2 sorted": (mangled("mk_resume_sorted_kernel") + (("mk_resume_kernel", "ILb1"),),
                              "mk_resume_sorted"),
                "K5": (mangled("mk_tiles_kernel", "ILb0"), "mk_tiles"),
                "K5 sorted": (mangled("mk_tiles_sorted_kernel") + (("mk_tiles_kernel", "ILb1"),),
                              "mk_tiles_sorted"),
                "K4": (mangled("mk_start_chained_kernel"), "mk_start_chained"),
                "K8": ((("sort_tiles_kernel", ""),), None)}

# The start/sorted groups' variants: {name: (tree it rewrites, {file:
# [(old text, new text, times it occurs)]}, what of its results may differ
# from the parent's: "order", the sorted launches' order record; "K8", K8's
# outputs)}. The parent's k8_copy splits its K8: the sort replaced by the
# identity permutation, so what is left is the copy.
_K5 = ("  persistent_paths<true, kFmt, kSh, kCache>(S, px, py, seeds, n, 1, cap, next,\n"
       "                                    TileFinish{n, out, rng_out});\n")
_K8_ISSUE = "  for (int b = 0; b < kRing; ++b) issue(sh, payload, T, C, tile, b);  // in flight during the sort\n"
PATH_VARIANTS = {
    "k8_copy": ("parent", {"sort.cu": [
        ("  const int src = hijiki_sort::block_sort<kTile>(k, scratch);\n", "  const int src = i;\n", 1)]},
        ("K8",)),
    # the package's parts, each taken back alone: K1 and K5 one path a
    # thread with the launch bounds and the stash (no persistent loop); K5
    # tracing every shadow ray (no gate), or without its minimum of blocks; the
    # sorted kernels without the minimum of 3 blocks; the packed network not
    # unrolled; two shuffles a stage (the packed word split in two); each
    # path written straight to its own column after the last pass, without
    # the exchange back to its own lane; K8 with its sort replaced by the
    # identity (the copy alone), its copies issued after the sort, one
    # channel a batch and one batch in flight, its network not unrolled
    "k1_onepath": ("new", {"megakernel.cu": [
        ("  persistent_paths<false, kFmt, kSh, kCache>(S, px, py, seeds, n, 1, cap, next,\n"
         "                                     StateFinish{n, st_out, rng_out});\n",
         "  const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
         "  __shared__ float stash[kStashWords * kThreads];\n"
         "  if (i >= n) return;\n"
         "  Path p{};\n"
         "  camera_init(S, px[i], py[i], seeds[i], p);\n"
         "  while (going(p, cap)) bounce<true, kThreads, false, kFmt, kSh>(S, p, stash + threadIdx.x);\n"
         "  write_state(p, st_out, rng_out, i, n);\n", 1),
        ("  return launch_persistent(FMT_KERNEL(S, mk_start_kernel), n, stream,",
         "  return launch_paths<false>(FMT_KERNEL(S, mk_start_kernel), n, 0, stream,", 1)]}, ()),
    "k5_onepath": ("new", {"megakernel.cu": [
        (_K5, "  const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
              "  __shared__ float stash[kStashWords * kThreads];\n"
              "  if (i >= n) return;\n"
              "  Path p{};\n"
              "  camera_init(S, px[i], py[i], seeds[i], p);\n"
              "  while (going(p, cap)) bounce<true, kThreads, true, kFmt, kSh>(S, p, stash + threadIdx.x);\n"
              "  write_tile(p, out, rng_out, i, n);\n", 1),
        ("  return launch_persistent(FMT_KERNEL(S, mk_tiles_kernel), n, stream,",
         "  return launch_paths<false>(FMT_KERNEL(S, mk_tiles_kernel), n, 0, stream,", 1)]}, ()),
    "k5_nogate": ("new", {"megakernel.cu": [(_K5, _K5.replace("<true,", "<false,"), 1)]}, ()),
    "k5_nobounds": ("new", {"megakernel.cu": [
        ("__global__ void __launch_bounds__(kThreads, kPersistMinBlocks)\n    mk_tiles_kernel(",
         "__global__ void __launch_bounds__(kThreads)\n    mk_tiles_kernel(", 1)]}, ()),
    "k8_nosort": ("new", {"sort.cu": [
        ("  const int src = hijiki_sort::block_sort<kTile>(k, sh.scratch);\n", "  const int src = i;\n", 1)]},
        ("K8",)),
    "k8_late": ("new", {"sort.cu": [
        (_K8_ISSUE, "", 1),
        ("  sh.src[i] = src;  // published by the first batch's barrier\n",
         "  sh.src[i] = src;  // published by the first batch's barrier\n" + _K8_ISSUE, 1)]}, ()),
    "k8_serial": ("new", {"sort.cu": [("constexpr int kBatch = 4;", "constexpr int kBatch = 1;", 1),
                                      ("constexpr int kRing = 4;", "constexpr int kRing = 1;", 1)]}, ()),
    "k8_rolled": ("new", {"sort.cuh": [
        ("#pragma unroll\n  for (int k = 2; k <= kTile; k <<= 1) {\n#pragma unroll\n    for (int j = k >> 1;",
         "#pragma unroll 1\n  for (int k = 2; k <= kTile; k <<= 1) {\n#pragma unroll 1\n    for (int j = k >> 1;",
         1)]}, ()),
    "sorted_nobounds": ("new", {"megakernel.cu": [
        ("__global__ void __launch_bounds__(kSortTile, kSortMinBlocks)\n",
         "__global__ void __launch_bounds__(kSortTile)\n", 3)]}, ()),
    "rolled": ("new", {"sort.cuh": [
        ("#pragma unroll\n  for (int lk = 1;", "#pragma unroll 1\n  for (int lk = 1;", 1),
        ("#pragma unroll\n    for (int lj = lk - 1;", "#pragma unroll 1\n    for (int lj = lk - 1;", 1)]},
        ()),
    "twoshuffle": ("new", {"sort.cuh": [
        ("        pv = __shfl_xor_sync(0xffffffffu, v, j);\n",
         "        pv = (__shfl_xor_sync(0xffffffffu, v >> kBits, j) << kBits) |\n"
         "             __shfl_xor_sync(0xffffffffu, v & (kTile - 1), j);\n", 1)]}, ()),
    "direct": ("new", {"megakernel.cu": [
        ("__device__ void bounce_loop_sorted(", "__device__ int bounce_loop_sorted(", 1),
        ("  // back to the path's own lane (the loop's last barrier follows every\n"
         "  // read of the last pass)\n"
         "  put_path<kSortTile>(p, my + (pid - lane));\n"
         "  __syncthreads();\n"
         "  get_path<kSortTile>(p, my);\n}\n", "  return pid;\n}\n", 1),
        ("  bounce_loop_sorted<kFmt, kSh, kCache>(S, p, cap, n, order);\n"
         "  if (i < n) write_state(p, st_out, rng_out, i, n);\n",
         "  const int g = blockIdx.x * kSortTile + bounce_loop_sorted<kFmt, kSh, kCache>(S, p, cap, n, order);\n"
         "  if (g < n) write_state(p, st_out, rng_out, g, n);\n", 2),
        ("  bounce_loop_sorted<kFmt, kSh, kCache>(S, p, cap, n, order);\n"
         "  if (i < n) write_tile(p, out, rng_out, i, n);\n",
         "  const int g = blockIdx.x * kSortTile + bounce_loop_sorted<kFmt, kSh, kCache>(S, p, cap, n, order);\n"
         "  if (g < n) write_tile(p, out, rng_out, g, n);\n", 1)]}, ()),
}


def rewrite(tree: Path, edits: dict) -> Path:
    """Apply a variant's text edits to the staged ``tree``; each old text
    must occur as often as the edit says (else the source moved on and the
    variant needs updating)."""
    from hijiki_tpu_torch.utils import build

    for fname, subs in edits.items():
        text = (tree / fname).read_text()
        for old, new, times in subs:
            if text.count(old) != times:
                raise SystemExit(f"{tree.name}: {fname} holds {text.count(old)} of {old!r}, not {times}")
            text = text.replace(old, new)
        (tree / fname).write_text(text)
    shutil.rmtree(build.BUILD_ROOT / build.cache_key(tree), ignore_errors=True)
    return tree


def takes_counter(src: str, fn: str) -> bool:
    """Whether the C entry ``fn`` of a megakernel.cu text takes a work
    counter (a persistent launch) before its stream."""
    entry = src[src.index(f'extern "C" int {fn}('):]
    return "next" in entry[:entry.index(")")]


class PathLib:
    """One built megakernel.cu library (with sort.cu: the start and sorted
    groups; with probe_walk.cu: the megakernel group's formats): K1, K2,
    K4, K5, the sorted K1/K2/K5, K8 where the library has it and the
    occupancy query. ``counter``: whether its K1, K4 and K5 are persistent
    and take a work counter before the stream (a tree's entry may lack it:
    one path a thread)."""

    def __init__(self, name: str, path: Path, report: str, tree: Path):
        self.name, self.path, self.report = name, path, report
        self.cdll = ctypes.CDLL(str(path))
        src = (tree / "megakernel.cu").read_text()
        self.counter = {fn: takes_counter(src, fn) for fn in ("mk_start", "mk_tiles", "mk_start_chained")}
        self.free = PATH_VARIANTS.get(name, (None, None, ()))[2]
        self.old = old_scene(tree)
        for fn in ("mk_start", "mk_resume", "mk_tiles", "mk_start_sorted", "mk_resume_sorted",
                   "mk_tiles_sorted", "sort_tiles", "mk_occupancy", "mk_start_chained"):
            if not hasattr(self.cdll, fn):
                continue
            argtypes = entry_argtypes(fn, self.old)
            if fn in self.counter and not self.counter[fn]:
                del argtypes[-2]  # the package's entry takes the counter there
            getattr(self.cdll, fn).argtypes = argtypes
            getattr(self.cdll, fn).restype = ctypes.c_int

    def call(self, fn: str, ms, *args, counter=None):
        import torch

        ptr = lambda a: a.data_ptr() if torch.is_tensor(a) else a
        tail = []
        if self.counter.get(fn):
            counter.zero_()
            tail = [counter.data_ptr()]
        scene = scene_args(ms, self.old) if fn != "sort_tiles" else ()
        rc = getattr(self.cdll, fn)(*scene, *map(ptr, args), *tail, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} {fn}: CUDA error {rc}")

    def kernels(self) -> dict:
        """{K1, K1 sorted, ...: registers, spill store bytes, local bytes,
        resident warps an SM} from ptxas and the occupancy query (ptxas'
        registers alone where the library's query does not know the
        kernel)."""
        from hijiki_tpu_torch.ops import megakernel as mk

        out = {}
        for k, (forms, occ_name) in PATH_KERNELS.items():
            try:
                regs, spill = ptxas_first(self.report, forms)
            except KeyError as e:
                raise RuntimeError(f"{self.name}: {k}: {e}") from None
            warps, local = None, None  # K8: no occupancy query
            if occ_name is not None:
                try:
                    occ = mk.occupancy(occ_name, self.cdll)
                    warps, local = occ["warps_per_sm"], occ["local_bytes"]
                except RuntimeError:  # a library whose query does not know the kernel
                    warps = warps_from_registers(regs, 256 if "sorted" in k else 128)
            out[k] = {"registers": regs, "spill_bytes": spill, "local_bytes": local, "warps_per_sm": warps}
        return out


def paths_ab(args, parent: Path, groups) -> tuple:
    """The start and sorted groups. start: K1 on the unchained 1024x1024
    sweep's camera launch, and K5's split on the 1M-path frame (its caps 5,
    12, 48 and 1000, the warp-bounces of its paths, and its tail floor: K5
    on the 32 paths of the most bounces alone, one warp). sorted: the
    sorted K1, the sweep's three K2 calls unsorted and sorted, K5 unsorted
    and sorted to 1000, and K8 on 1M lanes x 31 channels and on its keys
    alone (0 channels). Returns (their results, whether every library's
    outputs, and its order records where it must, equal the parent's)."""
    import numpy as np
    import torch

    from hijiki_tpu_torch.ops import megakernel as mk
    from hijiki_tpu_torch.probes import sass_functions
    from hijiki_tpu_torch.probes import walk_probe as pwk
    from hijiki_tpu_torch.render.renderer import RenderConfig, Renderer
    from hijiki_tpu_torch.scene.compile import compile_scene
    from hijiki_tpu_torch.scene.obj import load_obj_scene
    from hijiki_tpu_torch.utils import build

    with ThreadPoolExecutor(1) as ex:  # the package's own build (to record the calls) meanwhile
        pkg = ex.submit(build.build)
        pairs = build_libraries(parent, args.variants, PATH_FILES, PathLib)
        pkg.result()
    libs = [lib for lib, _ in pairs]
    result = {"libraries": {}, "times": {}, "checks": {}}
    print("library: registers, spill stores, local bytes, resident warps an SM of each kernel")
    for lib, secs in pairs:
        ks = lib.kernels()
        result["libraries"][lib.name] = {"build_s": secs, "persistent": lib.counter, "kernels": ks}
        print(f"  {lib.name:14s} built in {secs:.1f} s; " + "; ".join(
            f"{k} {v['registers']}/{v['spill_bytes']}/{v['local_bytes']}/{v['warps_per_sm']}"
            for k, v in ks.items()), flush=True)
    # SASS: each kernel's instruction count, and whether its code is the parent's
    sass = {lib.name: sass_functions("", lib.path) for lib in libs}
    result["sass"] = {}
    for k, (forms, _) in PATH_KERNELS.items():
        # the code of the first function of each library that is the kernel,
        # its labels unnumbered (a library's other functions shift them)
        code = {name: next(([(op, re.sub(r"\.L_x_\d+", ".L", rest)) for op, rest in c]
                            for f, (c, _, _) in every.items() if any(p in f for p in frags(forms))),
                           None)
                for name, every in sass.items()}
        if code["parent"] is None:
            continue
        result["sass"][k] = {name: {"instructions": len(c), "parent_code": c == code["parent"],
                                    "local": sum(op.startswith(("LDL", "STL")) for op, _ in c)}
                             for name, c in code.items() if c is not None}
        print(f"SASS {k}: " + "; ".join(
            f"{name} {v['instructions']} ({v['local']} LDL/STL"
            f"{', the parent code' if v['parent_code'] else ''})"
            for name, v in result["sass"][k].items()), flush=True)
    del sass

    dev = torch.device("cuda")
    scene = load_obj_scene(pwk.SCENE)
    scene.put_cbox_spheres()
    cfg = RenderConfig(width=1024, height=1024, spp=8, max_bounces=1000, block_size=128,
                       use_bvh=True, driver="mega")
    r = Renderer(compile_scene(scene, shadow_vis_boxes=False), cfg, device="cuda")
    ms = r.scene
    # chip_smoke's unchained sweep, its K1 and K2 calls recorded through the package
    px, py, seeds, _ = sweep_frame(r.scheduler.sweep(cfg.spp + 1 + mk.CHAIN_SWEEPS_CUDA), 1024, 1024, dev)
    calls = record_calls(mk, ["mk_start", "mk_resume"],
                         lambda: mk.render_waves(ms, px, py, seeds, max_bounces=1000))
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    n = px.numel()
    g = np.random.default_rng(5)
    T8, C8 = n // 1024, mk.N_STATE + 2  # K8: chip_smoke's 1M lanes x 31 channels
    key8 = torch.from_numpy(g.integers(0, 1 << 10, (T8, 1024)).astype(np.int32)).to(dev)
    key8[:, ::3] = 1 << 20
    ch8 = torch.from_numpy(g.integers(-2**31, 2**31 - 1, (C8, T8, 1024)).astype(np.int32)).to(dev)

    def state_outs(lanes, ch):
        return [torch.empty((ch, lanes), dtype=torch.float32, device=dev),
                torch.empty(lanes, dtype=torch.int32, device=dev)]

    cases = {}  # label -> (entry, args before the outputs, lanes, output channels)
    for name, a in calls:
        if name == "mk_start" and "start" in groups:
            cases[f"K1 ({n} lanes, cap {a[-1]})"] = ("mk_start", (*a[:3], n, a[-1]), n, mk.N_STATE)
        if "sorted" in groups:
            lanes = a[-2].numel()
            label = f"K{1 if name == 'mk_start' else 2} ({lanes} lanes, cap {a[-1]})"
            if name == "mk_resume":
                cases[label] = ("mk_resume", (*a[:2], lanes, a[-1]), lanes, mk.N_STATE)
            cases[label + " sorted"] = (name + "_sorted", (*a[:-1], lanes, a[-1]), lanes, mk.N_STATE)
    k5 = lambda cap: f"K5 ({n} paths to {cap})"
    floor = "K5 tail floor (the 32 paths of the most bounces, to 1000)"
    if "start" in groups:
        # the frame's paths to 1000 through the parent's K1: their bounces
        st = state_outs(n, mk.N_STATE)
        libs[0].call("mk_start", ms, px, py, seeds, n, 1000, *st, counter=counter)
        segs = st[0][mk._STATE_CH.index("segs")]
        wi = mk.warp_iterations(segs.view(1, -1))
        wi["sum_max/sum_mean"] = wi["sum_max"] / wi["sum_mean"]
        top = torch.argsort(segs, descending=True)[:32]
        result["k5_paths"] = {"warp_iterations": wi, "mean_segs": float(segs.double().mean()),
                              "floor_segs": [float(segs[top].min()), float(segs[top].max())]}
        print(f"K5's paths (K1 at cap 1000): mean {result['k5_paths']['mean_segs']:.4f} bounces, the 32 "
              f"longest {result['k5_paths']['floor_segs']}; warp-bounces a warp of 32 consecutive "
              "paths: " + ", ".join(f"{k} {v:.4f}" for k, v in wi.items()), flush=True)
        for cap in (5, 12, 48, 1000):
            cases[k5(cap)] = ("mk_tiles", (px, py, seeds, n, cap), n, len(mk._TILE_CH))
        cases[floor] = ("mk_tiles", (px[top].contiguous(), py[top].contiguous(), seeds[top].contiguous(),
                                     32, 1000), 32, len(mk._TILE_CH))
        del st
    k8 = lambda c: f"K8 sort_tiles ({T8} x 1024 lanes, {c} channels)"
    if "sorted" in groups:
        for suffix in ("", "_sorted"):
            cases[k5(1000) + suffix.replace("_", " ")] = (
                "mk_tiles" + suffix, (px, py, seeds, n, 1000), n, len(mk._TILE_CH))
        for c in (C8, 0):  # K8, and its keys alone
            cases[k8(c)] = ("sort_tiles", (key8, ch8[:c], T8, c), 0, 0)

    def make(entry, a, lanes, ch):
        if entry == "sort_tiles":
            return [torch.empty_like(a[0]), torch.empty_like(a[1])]
        return state_outs(lanes, ch) + ([None] if entry.endswith("_sorted") else [])

    def run(lib, entry, a, outs):
        lib.call(entry, ms, *a, *outs, counter=counter)
        return [o for o in outs if o is not None]

    # first launches: every library's outputs (and order records) against the parent's
    ok = True
    want = {}
    for c, (entry, a, lanes, ch) in cases.items():
        for lib in libs:
            got = [x.clone() for x in run(lib, entry, a, make(entry, a, lanes, ch))]
            rec = None
            if entry.endswith("_sorted"):
                outs = make(entry, a, lanes, ch)
                outs[-1] = torch.empty((2, lanes), dtype=torch.int32, device=dev)
                rec = run(lib, entry, a, outs)
            torch.cuda.synchronize()
            if lib.name == "parent":
                want[c] = (got, rec)
                if rec is not None and not bit_equal(rec[:2], got):
                    print(f"parent {c}: the launch with the order record DIFFERS from the one without")
                    ok = False
                continue
            same = bit_equal(got, want[c][0])
            line = f"{lib.name} {c}: {'bit-equal to' if same else 'DIFFERS from'} the parent's outputs"
            if entry == "sort_tiles" and "K8" in lib.free:
                line += " (a diagnostic variant: expected)" if not same else ""
            else:
                ok &= same
            if rec is not None:
                same_rec = bit_equal(rec, want[c][1])
                line += f"; order record {'equal to' if same_rec else 'differs from'} the parent's"
                if "order" in lib.free:
                    line += " (a diagnostic variant: expected)"
                else:
                    ok &= same_rec and bit_equal(rec[:2], got)
            result["checks"][f"{lib.name} {c}"] = line
            print(line, flush=True)
    for c, (entry, a, lanes, ch) in cases.items():  # a sorted launch equals the unsorted one
        if entry.endswith("_sorted"):
            plain_c = c[:-len(" sorted")]
            if plain_c not in want:  # K1: the sorted group without the start group
                continue
            same = bit_equal(want[c][0], want[plain_c][0])
            ok &= same
            print(f"parent {c}: {'bit-equal to' if same else 'DIFFERS from'} its unsorted launch", flush=True)
    del want

    def event_ms(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    held = {(c, lib.name): make(e, a, lanes, ch) for c, (e, a, lanes, ch) in cases.items() for lib in libs}
    times = {c: {lib.name: [] for lib in libs} for c in cases}
    # K8 runs K8_BURST launches back to back in the event window (its time
    # a launch: the host's launch latency, tens of microseconds, would
    # otherwise count in a kernel of ~0.1 ms)
    burst = {c: K8_BURST if entry == "sort_tiles" else 1 for c, (entry, _, _, _) in cases.items()}

    def launches(lib, c, entry, a):
        for _ in range(burst[c]):
            run(lib, entry, a, held[(c, lib.name)])

    for rep in range(args.reps + 1):  # round 0 warms up
        for c, (entry, a, _, _) in cases.items():
            for lib in (libs if rep % 2 else libs[::-1]):  # alternate the order
                t_ms = event_ms(lambda: launches(lib, c, entry, a)) / burst[c]
                if rep:
                    times[c][lib.name].append(t_ms)
    del held
    for c, by_lib in times.items():
        base = summary(by_lib["parent"])
        result["times"][c] = {}
        for name, ts in by_lib.items():
            sm = summary(ts)
            sm["ratio_min"] = sm["min_ms"] / base["min_ms"]
            sm["ratio_median"] = sm["median_ms"] / base["median_ms"]
            result["times"][c][name] = sm
            print(f"{c:60s} {name:14s} min {sm['min_ms']:9.4f} ms, median {sm['median_ms']:9.4f} ms "
                  f"(x{sm['ratio_min']:.4f} / x{sm['ratio_median']:.4f} the parent's)", flush=True)

    # the splits (min times): K5's caps, floor and bulk; K8's sort and copy
    tmin = lambda c, name: result["times"][c][name]["min_ms"]
    result["split"] = {}
    for lib in libs:
        split = {}
        if floor in cases:
            split["K5"] = {f"cap {cap}": tmin(k5(cap), lib.name) for cap in (5, 12, 48, 1000)}
            split["K5"]["floor"] = tmin(floor, lib.name)
            split["K5"]["bulk"] = tmin(k5(1000), lib.name) - tmin(floor, lib.name)
        if k8(0) in cases:
            split["K8"] = {"all": tmin(k8(C8), lib.name), "keys alone": tmin(k8(0), lib.name),
                           "channels": tmin(k8(C8), lib.name) - tmin(k8(0), lib.name)}
        result["split"][lib.name] = split
        for k, parts in split.items():
            print(f"split of {k}, {lib.name} (min ms): " + ", ".join(f"{p} {v:.4f}" for p, v in parts.items()),
                  flush=True)
    return result, ok


# ---- the probes group: K10a (walk_ablate) and K11a staged_chase ----

PROBE_FILES = ("probe_walk.cu", "probe_latency.cu")
# staged_chase's cases timed (K10a's: every variant of
# probes/ablate_walker.py, each at G = 1 and 32): {label: (mode, height,
# nchains, spec)}
PROBE_STAGED = {"staged chase": ("chase", 1, 1, False), "staged indep": ("indep", 1, 1, False),
                "staged multi G=4 spec": ("multi", 1, 4, True)}
PROBE_ITERS = {"walk_ablate": 16, "staged_chase": 8}  # chip_smoke's (k) shapes
# the kernels reported: a part of the mangled name of each timed case's
# instantiation (walk_ablate_kernel<flags, G>, staged_*_kernel<mode>)
PROBE_KERNELS = {"K10a full G=1": ("walk_ablate_kernel", "ILi63ELi1E"),
                 "K10a full G=32": ("walk_ablate_kernel", "ILi63ELi32E"),
                 "K10a noprefetch G=1": ("walk_ablate_kernel", "ILi61ELi1E"),
                 "K10a noprefetch G=32": ("walk_ablate_kernel", "ILi61ELi32E"),
                 "K10a noprim G=1": ("walk_ablate_kernel", "ILi47ELi1E"),
                 "K10a noprim G=32": ("walk_ablate_kernel", "ILi47ELi32E"),
                 "staged chase": ("staged_chase_kernel", "ILi1E"),
                 "staged indep": ("staged_chase_kernel", "ILi0E"),
                 "staged multi G=4 spec": ("staged_multi_kernel", "ILi4ELb1E")}


class ProbeLib:
    """One built probe_walk.cu + probe_latency.cu library: K10a and K11a
    staged_chase at their C entries (build.SIGNATURES)."""

    def __init__(self, name: str, path: Path, report: str, tree: Path):
        from hijiki_tpu_torch.utils import build

        self.name, self.path, self.report = name, path, report
        self.cdll = ctypes.CDLL(str(path))
        for fn in ("walk_ablate", "staged_chase"):
            getattr(self.cdll, fn).argtypes = build.SIGNATURES[fn]
            getattr(self.cdll, fn).restype = ctypes.c_int

    def call(self, fn: str, *args, occupancy: bool = False) -> int:
        """Launch ``fn`` with ``args`` (tensors as their pointers), or with
        ``occupancy`` return the blocks of the call's shape an SM holds."""
        import torch

        occ = ctypes.c_int(0)
        rc = getattr(self.cdll, fn)(*(a.data_ptr() if torch.is_tensor(a) else a for a in args),
                                    ctypes.byref(occ) if occupancy else None,
                                    torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} {fn}: CUDA error {rc}")
        return occ.value


def sass_counts(ops) -> dict:
    """A probe kernel's memory instructions by kind: loads as 128-bit LDGs
    and as narrower ones, cp.async's LDGSTS against the bulk copy (UBLKCP),
    128-bit and narrower stores."""
    count = lambda test: sum(1 for op, _ in ops if test(op))
    return {"LDG.128": count(lambda op: op.startswith("LDG.") and ".128" in op),
            "LDG narrower": count(lambda op: op.startswith("LDG.") and ".128" not in op),
            "LDGSTS": count(lambda op: op.startswith("LDGSTS")),
            "UBLKCP": count(lambda op: "BLKCP" in op),
            "STG.128": count(lambda op: op.startswith("STG") and ".128" in op),
            "STG narrower": count(lambda op: op.startswith("STG") and ".128" not in op),
            "instructions": len(ops)}


def probes_ab(args, parent: Path) -> tuple:
    """The probes group: K10a (every variant at G = 1 and 32 on 1M random
    rays over the meshbox + spheres rows, 16 steps) and K11a staged_chase
    (``PROBE_STAGED`` at 32,768 warps, 8 steps, on the height-2 (65536,
    128) table of chip_smoke's (k) call, 32 threads a block), the libraries
    in turn; outputs equal the parent's bit for bit, and the package's K10a
    loads rows with 128-bit loads only (every instantiation). Returns (its
    results, whether both hold)."""
    import torch

    from hijiki_tpu_torch.probes import ablate_walker as pab
    from hijiki_tpu_torch.probes import chain_latency_probe as pcl
    from hijiki_tpu_torch.probes import sass_functions
    from hijiki_tpu_torch.probes import walk_probe as pwk
    from hijiki_tpu_torch.utils import build

    pairs = build_libraries(parent, args.variants, PROBE_FILES, ProbeLib)
    libs = [lib for lib, _ in pairs]
    dev = torch.device("cuda")
    ms, cs = pwk.load_scene(pwk.SCENE, dev)
    n = 1 << 20
    o, d = pwk.ray_set("random", cs, n, dev)
    tbl = torch.from_numpy(pcl.dma_table(65536, height=2)).to(dev)
    nblk = n // 32
    result = {"libraries": {}, "times": {}, "outputs_equal": {}}

    cases = {}  # label -> (entry, args before the output, output shape, threads a block)
    for name in pab.VARIANTS:
        for g in (1, 32):
            cases[f"K10a {name} G={g}"] = (
                "walk_ablate", (ms.rows, ms.rows.shape[0], o, d, n, PROBE_ITERS["walk_ablate"],
                                pab.variant_flags(pab.VARIANTS[name]), g), (2, n), pab.FULL_BLOCK)
    for k, (mode, h, g, spec) in PROBE_STAGED.items():
        cases[k] = ("staged_chase", (pcl.STAGE_MODES[mode], tbl, tbl.shape[0], nblk,
                                     PROBE_ITERS["staged_chase"], h, g, int(spec)),
                    (nblk, pcl.SUBLANES, pcl.ROW_F), 32)

    print("library: registers / spill stores / warps an SM of each timed kernel (ptxas; the "
          "occupancy query at its block)")
    for lib, secs in pairs:
        ks = {}
        for k, form in PROBE_KERNELS.items():
            try:
                hit = build.ptxas_of(lib.report, *form)
            except KeyError as e:
                raise RuntimeError(f"{lib.name}: {k}: {e}") from None
            fn, a, _, block = cases[k]
            ks[k] = {"registers": hit[0], "spill_bytes": hit[1],
                     "warps_per_sm": lib.call(fn, *a, block, None, occupancy=True) * block // 32}
        result["libraries"][lib.name] = {"build_s": secs, "kernels": ks}
        print(f"  {lib.name:14s} built in {secs:.1f} s; " + "; ".join(
            f"{k} {v['registers']}/{v['spill_bytes']}/{v['warps_per_sm']}" for k, v in ks.items()),
            flush=True)

    # first launches: every library's outputs against the parent's
    outs = {}
    for lib in libs:
        for label, (fn, a, shape, block) in cases.items():
            out = torch.empty(shape, dtype=torch.float32, device=dev)
            lib.call(fn, *a, block, out)
            outs[(lib.name, label)] = out
    torch.cuda.synchronize()
    ok = True
    for lib in libs[1:]:
        for label in cases:
            same = bit_equal((outs[(lib.name, label)],), (outs[("parent", label)],))
            ok &= same
            result["outputs_equal"][f"{lib.name} {label}"] = same
            if not same:
                print(f"{lib.name} {label}: DIFFERS from the parent's outputs", flush=True)
    print(f"outputs: {'every library bit-equal to the parent on every case' if ok else 'DIFFER'}",
          flush=True)

    # timing: each case, the libraries in turn (the order reversed every
    # other round), each launch between two events
    times = {label: {lib.name: [] for lib in libs} for label in cases}
    for rep in range(args.reps + 1):  # round 0 warms up
        order = libs if rep % 2 else libs[::-1]
        for label, (fn, a, _, block) in cases.items():
            for lib in order:
                out = outs[(lib.name, label)]
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                torch.cuda.synchronize()
                ev[0].record()
                lib.call(fn, *a, block, out)
                ev[1].record()
                ev[1].synchronize()
                if rep:
                    times[label][lib.name].append(ev[0].elapsed_time(ev[1]))
    for label, by_lib in times.items():
        base = summary(by_lib["parent"])
        result["times"][label] = {}
        for name, ts in by_lib.items():
            sm = summary(ts)
            sm["ratio_median"] = sm["median_ms"] / base["median_ms"]
            result["times"][label][name] = sm
            print(f"{label:34s} {name:14s} min {sm['min_ms']:9.4f} ms, median {sm['median_ms']:9.4f} ms "
                  f"(x{sm['ratio_median']:.4f} the parent's median)", flush=True)

    # SASS: the timed kernels' memory instructions
    args.sass.mkdir(parents=True, exist_ok=True)
    result["sass"] = {}
    for lib in libs:
        every = sass_functions("", lib.path)
        for k, form in PROBE_KERNELS.items():
            frag = frags([form])[0]
            found = [(f, v) for f, v in every.items() if frag in f]
            if not found:
                continue
            fname, (code, loops, text) = found[0]
            (args.sass / f"{lib.name}_{frag}.sass").write_text(text)
            start, end = max(loops, key=lambda lp: lp[1] - lp[0], default=(0, -1))
            counts = {"function": sass_counts(code), "longest loop": sass_counts(code[start:end + 1])}
            result["sass"][f"{lib.name} {k}"] = counts
            print(f"SASS {lib.name} {k}: " + "; ".join(
                f"{part} " + ", ".join(f"{c} {v}" for c, v in cnt.items() if v)
                for part, cnt in counts.items()), flush=True)
    # K10a's row loads in every instantiation: 128-bit only in the package's
    try:
        loads = pab.check_row_loads(next(lib.path for lib in libs if lib.name == "new"))
        print(f"SASS new K10a: all {len(loads)} instantiations load rows with 128-bit loads only "
              "(<flags, G>: LDG.E.128/narrower): " + ", ".join(
                  "<{}, {}>: {}/{}".format(*re.search(r"ILi(\d+)ELi(\d+)E", f).groups(), a, b)
                  for f, (a, b) in loads.items()),
              flush=True)
    except RuntimeError as e:
        loads, ok = str(e), False
        print(f"SASS new K10a: {e}", flush=True)
    result["sass"]["new K10a row loads"] = loads
    return result, ok


def unhashed(text: str) -> str:
    """``text`` with each anonymous namespace's mangled name made the same
    in every build: nvcc names it after the source's path and a hash
    (``_ZN46_GLOBAL__N__2f66ee29_13_probe_walk_cu_0ec4f68a...``), which
    differ between two staged trees of the same source."""
    out, pos = [], 0
    for m in re.finditer(r"(\d+)(_GLOBAL__N_)", text):
        if m.start() < pos:
            continue
        out.append(text[pos:m.start()] + "12_GLOBAL__N_1")
        pos = m.start(2) + int(m.group(1))
    return "".join(out) + text[pos:]


def sass_ab(args, parent: Path) -> tuple:
    """The sass group: every csrc/*.cu of the parent and of the package
    built (all at once), and each kernel function of the parent compared
    with the package's of the same mangled name: registers and spill
    stores (ptxas), SASS instruction count and code (labels unnumbered).
    Prints the functions that differ and, by family (K1-K8, K9, K10a, K10b,
    K11a, K11b), how many are the parent's; and each packed walk's loads in
    both trees (``walk_probe.check_packed_loads``: 128-bit and narrower
    LDGs, LDL/STL in its walk loops and in all). Returns (its results,
    True)."""
    from hijiki_tpu_torch.probes import sass_functions
    from hijiki_tpu_torch.utils import build

    files = tuple(sorted(p.name for p in parent.glob("*.cu")))
    pairs = build_libraries(parent, "", files, lambda name, path, report, tree: (name, path, report))
    libs = {name: (path, {unhashed(f): v for f, v in build.ptxas_table(report).items()})
            for (name, path, report), _ in pairs}
    code = {}
    for name, (path, _) in libs.items():
        code[name] = {unhashed(f): [(op, unhashed(re.sub(r"\.L_x_\d+", ".L", rest))) for op, rest in c]
                      for f, (c, _, _) in sass_functions("", path).items()}
    families = {"K1-K5, K7 (megakernel.cu)": ("mk_",), "K3": ("reconstruct_kernel",),
                "K6": ("traverse_kernel",), "K8": ("sort_tiles_kernel",),
                "K9": ("reconstruct_old_kernel",), "K10a": ("walk_ablate_kernel",),
                "K10b": ("walk_isolate",), "K11a latency_chain": ("latency_chain_kernel",),
                "K11a staged_chase": ("staged_chase_kernel", "staged_multi_kernel"),
                "K11b": ("alu_issue_kernel", "ew_", "dtype_slab_kernel")}
    result = {}
    for fam, parts in families.items():
        names = sorted(f for f in set(code["parent"]) | set(code["new"]) if any(p in f for p in parts))
        same, differ = [], []
        for f in names:
            a, b = code["parent"].get(f), code["new"].get(f)
            ra, rb = libs["parent"][1].get(f), libs["new"][1].get(f)
            (same if a is not None and a == b and ra == rb else differ).append(f)
        sizes = [(len(code["parent"].get(f) or []), len(code["new"].get(f) or [])) for f in names]
        result[fam] = {"functions": len(names), "parent_code": len(same), "differ": differ,
                       "sass_sizes": dict(zip(names, sizes)),
                       "registers_spills": {f: (libs["parent"][1].get(f), libs["new"][1].get(f))
                                            for f in names}}
        print(f"SASS {fam}: {len(same)} of {len(names)} functions the parent's code, registers "
              f"and spills", flush=True)
        for f in differ:
            print(f"    differs: {f}: registers/spills {libs['parent'][1].get(f)} -> "
                  f"{libs['new'][1].get(f)}, SASS {len(code['parent'].get(f) or [])} -> "
                  f"{len(code['new'].get(f) or [])} instructions", flush=True)
    # the packed walks' loads (K10b, K1, K4), the parent's and the package's
    from hijiki_tpu_torch.probes import walk_probe

    loads = {name: walk_probe.check_packed_loads(path, hold=False)
             for name, (path, _) in libs.items()}
    result["packed walks"] = {f"{k}<{t}>": {name: loads[name][(k, t)] for name in loads}
                              for k, t in loads["new"]}
    print("SASS packed walks (128-bit LDGs, narrower LDGs in the walk loops, LDL/STL in the walk "
          "loops, LDL/STL in all): parent -> package", flush=True)
    for key, by in result["packed walks"].items():
        print(f"    {key}: {by['parent']} -> {by['new']}", flush=True)
    return result, True


if __name__ == "__main__":
    raise SystemExit(main())
