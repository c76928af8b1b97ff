"""Probe the lane-sorted megakernels (K7 inside K1/K2/K5) on the card: the
sort tile's registers, spills and time, and the lane-sort key, sorted
against unsorted.

    python tools/probe_sort_tile.py [--variants 256:full,512:full,1024:full]
                                    [--size 1024]

Each variant TILE:KEY is a copy of csrc/ whose megakernel.cu sorts tiles of
TILE lanes (``kSortTile``) by the key KEY, built like the package's
sources (``build.build``), with ptxas' registers, spills and shared memory
printed. KEY is ``full`` (the kernel's own: dead last, octant, origin
cell), ``dead`` (dead last only: compaction without direction coherence),
``identity`` (each lane's own index: the sort and the exchange run at full
cost and move nothing) or ``lockstep`` (no key, no sort, no exchange: only
the block's barrier per bounce).

Records the inputs of every K1 and K2 call of one unsorted ``render_waves``
sweep of the meshbox (+ cbox spheres) at ``--size``², then replays each
call through the unsorted kernel and each variant's sorted one: outputs
bit-equal (int32 views, NaN included; they cannot show the sort), and at
the package's tile the order record of the last sort against the sorted
plain version's (``chip_smoke.order_mismatch``: every key but ``full``
fails it, which shows that the check sees the sort). Times from CUDA
events (mean of 3 warm runs, after two untimed replays of the whole sweep).
K5 likewise on the whole frame, without the order check. Finally the
standalone K8 ``sort_tiles`` at the frame's lane count x 31 channels
against its plain version, and beside ``torch.sort(stable=True)`` +
``gather``. Needs a CUDA card and nvcc; imports only the port and
chip_smoke's helpers.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))

from chip_smoke import bit_equal, order_mismatch, record_calls, timed  # noqa: E402

# the lines of megakernel.cu each variant rewrites
TILE_LINE = "constexpr int kSortTile = 256;"
KEY_LINE = "  if (!(p.alive > 0.0f)) return kDeadKey;"
SORT_LINES = ("    int key = lane_key(S, p);\n"
              "    put_path<kSortTile>(p, my);\n"
              "    if constexpr (kCache) my[kPredWord * kSortTile] = __int_as_float(pred);\n"
              "    const int src = hijiki_sort::block_sort_packed<kSortTile, kDeadKey>(key, lane, sh.sort);\n"
              "    get_path<kSortTile>(p, my + (src - lane));\n"
              "    pid = __float_as_int(my[kPidWord * kSortTile + (src - lane)]);\n"
              "    if constexpr (kCache) pred = __float_as_int(my[kPredWord * kSortTile + (src - lane)]);\n")
KEYS = {"full": {}, "dead": {KEY_LINE: "  return p.alive > 0.0f ? 0 : kDeadKey;"},
        "identity": {KEY_LINE: "  return threadIdx.x;"}, "lockstep": {SORT_LINES: ""}}


def build_variant(variant: str):
    """Build csrc/ with megakernel.cu rewritten for ``variant`` (TILE:KEY);
    returns the library's path."""
    from hijiki_tpu_torch.utils import build

    tile, key = variant.split(":")
    src = (build.CSRC / "megakernel.cu").read_text()
    for line in (TILE_LINE, KEY_LINE, SORT_LINES):
        if src.count(line) != 1:
            raise RuntimeError(f"megakernel.cu changed: update this probe's lines ({line!r})")
    src = src.replace(TILE_LINE, f"constexpr int kSortTile = {int(tile)};")
    for old, new in KEYS[key].items():
        src = src.replace(old, new)
    csrc = build.BUILD_ROOT.parent / "probe_sort_tile" / variant.replace(":", "_")
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(build.CSRC, csrc)
    (csrc / "megakernel.cu").write_text(src)
    path, secs, report = build.build(csrc)
    print(f"-- {variant}: built in {secs:.1f} s; ptxas")
    for line in report.splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry")):
            print("  ", line.strip())
    return path


def main(argv=None) -> int:
    import numpy as np
    import torch

    from hijiki_tpu_torch.ops import megakernel as mk
    from hijiki_tpu_torch.ops import sort as srt
    from hijiki_tpu_torch.ops.rng import to_bits
    from hijiki_tpu_torch.render.blocks import BlockScheduler, per_pixel_seeds_device
    from hijiki_tpu_torch.scene.compile import compile_scene
    from hijiki_tpu_torch.scene.obj import load_obj_scene
    from hijiki_tpu_torch.utils import build

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--variants", default="256:full,512:full,1024:full")
    p.add_argument("--size", type=int, default=1024)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    default_lib = build.build()[0]
    libs = {v: build_variant(v) for v in args.variants.split(",")}
    build.load_library(default_lib)

    scene = load_obj_scene(os.path.join(HERE, "..", "scenes", "meshbox", "meshbox.obj"))
    scene.put_cbox_spheres()
    W = H = args.size
    ms = mk.mega_scene(compile_scene(scene), W, H, dev)
    sched = BlockScheduler(W, H, 128, 0).sweep(0)
    so = np.asarray(sched.sample_offset, np.float32)
    y, x = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                          torch.arange(W, device=dev, dtype=torch.float32), indexing="ij")
    px = (x + float(so[0])).reshape(-1).contiguous()
    py = (y + float(so[1])).reshape(-1).contiguous()
    seeds = to_bits(per_pixel_seeds_device(W, H, 128, sched.block_seeds, dev).reshape(-1))

    real = {"mk_start": mk.megakernel_start, "mk_resume": mk.megakernel_resume}
    plain = {"mk_start": mk.megakernel_start_plain, "mk_resume": mk.megakernel_resume_plain}
    calls = record_calls(mk, real, lambda: mk.render_waves(ms, px, py, seeds, max_bounces=1000))
    plain_orders = {}  # the sorted plain version's order record of each call
    for _ in range(2):  # warm the card: a cold first replay reads several times slower
        for name, a in calls:
            real[name](ms, *a)
        mk.megakernel_tiles(ms, px, py, seeds, 1000)
    torch.cuda.synchronize()
    for v, path in libs.items():
        build.load_library(path)
        tot_u = tot_s = 0.0
        for c, (name, a) in enumerate(calls):
            t_u, want = timed(lambda: real[name](ms, *a), reps=3)
            t_s, got = timed(lambda: real[name](ms, *a, lane_sort=True), reps=3)
            eq = bit_equal(got, want)
            order = ""
            if int(v.split(":")[0]) == mk.SORT_TILE:
                if c not in plain_orders:
                    plain_orders[c] = plain[name](ms, *a, lane_sort=True, lane_order=True)
                rec = real[name](ms, *a, lane_sort=True, lane_order=True)
                why = order_mismatch(mk, ms, rec, plain_orders[c])
                order = f", order record: {why or 'equal to the plain version'}"
            live = int((a[0][0] > 0).sum()) if name == "mk_resume" else a[0].numel()
            print(f"{v}: K{1 if name == 'mk_start' else 2} {a[-2].numel()} lanes ({live} live), "
                  f"cap {a[-1]}: unsorted {t_u:.3f} ms, sorted {t_s:.3f} ms, bit-equal {eq}{order}",
                  flush=True)
            tot_u += t_u
            tot_s += t_s
            if not eq:
                return 1
        t_u, want = timed(lambda: mk.megakernel_tiles(ms, px, py, seeds, 1000), reps=3)
        t_s, got = timed(lambda: mk.megakernel_tiles(ms, px, py, seeds, 1000, lane_sort=True), reps=3)
        print(f"{v}: K1+K2 of the sweep unsorted {tot_u:.3f} ms, sorted {tot_s:.3f} ms; "
              f"K5 ({px.numel()} paths to 1000) unsorted {t_u:.3f} ms, sorted {t_s:.3f} ms, "
              f"bit-equal {bit_equal(got, want)}", flush=True)
    build.load_library(default_lib)

    rng = np.random.default_rng(5)
    T, C = (W * H) // srt.TILE, mk.N_STATE + 2
    key = torch.from_numpy(rng.integers(0, 1 << 10, (T, srt.TILE)).astype(np.int32)).to(dev)
    key[:, ::3] = 1 << 20
    chans = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (C, T, srt.TILE)).astype(np.int32)).to(dev)
    t_k, got = timed(lambda: srt.sort_tiles(key, chans), reps=10)
    want = srt.sort_tiles_plain(key, chans)
    t_lib, _ = timed(lambda: torch.gather(
        chans, 2, torch.sort(key, dim=1, stable=True).indices.expand(C, T, srt.TILE)), reps=10)
    nb = 2 * (key.numel() + chans.numel()) * 4
    print(f"K8 sort_tiles ({T} tiles x {srt.TILE} lanes, {C} channels): {t_k:.4f} ms, bit-equal to "
          f"plain {bit_equal(got, want)}; torch.sort+gather {t_lib:.4f} ms; bound "
          f"{nb / 3.35e12 * 1e3:.4f} ms ({nb / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
