"""K10b: the walk-isolation probe on the H100.

Counterpart of tools/walk_probe.py (``walk_kernel``/``make_runner``,
pallas_call at :84; ``patch_no_test`` :178; ``make_w16_scene`` and
``patch_normals_at_11`` :133-175; ``main`` :246 and ``main_widths`` :192).
The render kernels' own closest-hit walk (csrc/walk.cuh: the analytic
pretest, then the walk from the octant table of the ray's direction, stopped
before the winner resolve; ``walk_packed`` on a packed table) on camera or
random rays, outside the bounce loop; out: t and the rows visited per ray.

* ``walk_isolate_plain``: the plain version (any device): a lockstep walk of
  groups of ``group`` rays; ``group = 1`` is the render kernels' per-ray
  walk (ops/megakernel.py::_walk), ``group = 32`` a 32-ray packet (the
  octant table of the packet's majority direction, descend when any ray's
  slab test passes, accept per ray).
* ``walk_isolate``: the CUDA kernel on a CUDA tensor, the plain version on a
  CPU tensor. ``iters`` is the slope method's trip count: trip k walks ray
  i + 2144 k (mod n) in thread i, so no trip finds the rows of the trip
  before in L1, and the last walks ray i (the result is the same).

Variants: a table (``TABLES``: ``w32`` the classic rows, ``w16``
``w16_rows``' columns 0-10 and the plane normal in 11-13, ``slim``,
``pack3``, ``pack4`` and ``pack12`` the scene compiled with packed_leaf 1,
3, 4 and 12; the tool's ``unpacked`` and ``packed`` are ``w32`` and
``pack4``), each also as ``-notest`` (every prim row misses, the tool's
patch_no_test). t equals the JAX tool's up to the FMA/t-tie class; the
JAX walk counts packet unions, so its rows visited are not compared.

Modes, as the tool's: the default (``main``: the slope timings of the
variants, by default the tool's unpacked and packed with and without the
prim test, at one warp per SM and at 1M threads, G = 1 and 32, then the
prim test's share of a row step), and ``widths`` (``main_widths``: one walk
of a W x W camera frame over each table, G = 1, timed in turns, the best of
7: ms, rows per ray, the t sum and the speed against ``w32``). Both run on
the meshbox + spheres (the tool's cbox is absent).

    python -m hijiki_tpu_torch.probes.walk_probe [widths] [W] [--variants ...]
        [--rays camera random] [--device cuda|cpu] [--json out.json]
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from hijiki_tpu_torch.ops import megakernel as mk
from hijiki_tpu_torch.probes import (GROUPS, SCENE, call, card, check, device_of, dump, f32,
                                     occupancies, parser)

M_EPS = 1e-4
# the tables a variant walks: compile_scene's packed_leaf (w16: the classic
# rows narrowed by w16_rows)
TABLES = {"w32": 0, "w16": 0, "slim": 1, "pack3": 3, "pack4": 4, "pack12": 12}
# the tool's main() names for two of them
ALIASES = {"unpacked": "w32", "packed": "pack4"}
# variant -> (table, prim test on)
VARIANTS = {name + tag: (ALIASES.get(name, name), not tag)
            for name in (*TABLES, *ALIASES) for tag in ("", "-notest")}
MAIN_VARIANTS = ("unpacked", "packed", "unpacked-notest", "packed-notest")
WIDTHS = ("w32", "w16", "slim", "pack3", "pack4", "pack12")
# a packed format's row width in floats (csrc/walk.cuh packed_width)
PACKED_WIDTH = {1: 16, 3: 32, 4: 64, 12: 128}

# launches of the CUDA kernel (CPU calls of the plain version are not counted):
# on the classic rows (and their 16-column copy), and on each packed table
_LAUNCH_KEY = {0: "walk_isolate", 1: "walk_isolate_slim", 3: "walk_isolate_pack3",
               4: "walk_isolate_pack4", 12: "walk_isolate_pack12"}
LAUNCHES = {k: 0 for k in _LAUNCH_KEY.values()}


def load_scene(path: str, device, width: int = 1024, height: int = 1024, packed_leaf=0):
    """The port's scene (OBJ with the cbox spheres, as chip_smoke.py uses
    it) baked for the walk with ``packed_leaf``'s table (the closest-hit
    walk reads no shadow-visibility box, so none is proven): (MegaScene,
    CompiledScene)."""
    from hijiki_tpu_torch.scene.compile import compile_scene
    from hijiki_tpu_torch.scene.obj import load_obj_scene

    scene = load_obj_scene(path)
    scene.put_cbox_spheres()
    cs = compile_scene(scene, packed_leaf=packed_leaf, shadow_vis_boxes=False)
    return mk.mega_scene(cs, width, height, device), cs


def load_tables(path: str, device, names, width: int = 1024, compiled=None):
    """{table name: (MegaScene, its rows)} of the ``names`` of ``TABLES``
    (each packed_leaf compiled once, or taken from ``compiled``:
    {packed_leaf: CompiledScene of ``path``}), and the classic scene's
    CompiledScene (the camera and the random rays' box)."""
    compiled = compiled or {}
    scenes = {}
    for leaf in sorted({TABLES[t] for t in names} | {0}):
        scenes[leaf] = ((mk.mega_scene(compiled[leaf], width, width, device), compiled[leaf])
                        if leaf in compiled else load_scene(path, device, width, width, leaf))
    out = {}
    for t in names:
        ms = scenes[TABLES[t]][0]
        out[t] = (ms, w16_rows(ms.rows).contiguous() if t == "w16" else ms.rows)
    return out, scenes[0][1]


def w16_rows(rows):
    """``make_w16_scene``'s table: columns 0-10 and the plane normal (29-31)
    at 11-13 of a 16-wide row."""
    slim = torch.zeros((rows.shape[0], 16), dtype=rows.dtype, device=rows.device)
    slim[:, :11] = rows[:, :11]
    slim[:, 11:14] = rows[:, 29:32]
    return slim


def camera_rays_np(camera_static, W: int, H: int):
    """The tool's camera_rays_np: pixel-centre pinhole rays of a W x H frame
    in double precision, as (3, W*H) f32 origins and directions."""
    cx, cy, cz, qx, qy, qz, qw, fov = camera_static
    R = np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
    ])
    idx = np.arange(W * H)
    px = (idx % W) + 0.5
    py = (idx // W) + 0.5
    scale = math.tan(math.radians(0.5 * fov)) / (0.5 * W)
    lx = (px - 0.5 * W) * scale
    ly = -(py - 0.5 * H) * scale
    d = np.stack([lx, ly, -np.ones_like(lx)], -1) @ R.T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(np.array([cx, cy, cz]), d.shape)
    return np.ascontiguousarray(o.T, np.float32), np.ascontiguousarray(d.T, np.float32)


def random_rays_np(cs, n: int, seed: int = 7):
    """n rays with origins uniform in the scene's BVH box and normal
    directions, normalized (the K6 replay's random set): (3, n) f32 each."""
    g = np.random.default_rng(seed)
    lo = np.asarray(cs.bvh_aabb_min, np.float32)[0]
    hi = np.asarray(cs.bvh_aabb_max, np.float32)[0]
    o = (lo + (hi - lo) * g.random((n, 3))).astype(np.float32)
    d = g.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.ascontiguousarray(o.T), np.ascontiguousarray(d.T)


def ray_set(kind: str, cs, n: int, device, frame: int = 1024):
    """n rays on ``device`` as (3, n) f32: ``camera`` (a frame x frame
    camera frame, every (frame^2 / n)-th pixel when n is smaller) or
    ``random``."""
    if kind == "camera":
        o, d = camera_rays_np(cs.camera_static, frame, frame)
        step = max(1, o.shape[1] // n)
        o, d = o[:, ::step][:, :n], d[:, ::step][:, :n]
    else:
        o, d = random_rays_np(cs, n)
    return (torch.from_numpy(np.ascontiguousarray(o)).to(device),
            torch.from_numpy(np.ascontiguousarray(d)).to(device))


def _tri_test(r, o, d, tmin, nrm):
    """The analytic-mode prim test with the plane normal at column ``nrm``
    (walk.cuh prim_test<kNrm>): (phit, t, u, v)."""
    ox, oy, oz = o
    dx, dy, dz = d
    col = lambda j: r[:, j]
    nx, ny, nz = col(nrm), col(nrm + 1), col(nrm + 2)
    rx, ry, rz = ox - col(0), oy - col(1), oz - col(2)
    qx = ry * dz - rz * dy
    qy = rz * dx - rx * dz
    qz = rx * dy - ry * dx
    dd = 1.0 / (dx * nx + dy * ny + dz * nz)
    u = -dd * (qx * col(6) + qy * col(7) + qz * col(8))
    v = dd * (qx * col(3) + qy * col(4) + qz * col(5))
    t = -dd * (nx * rx + ny * ry + nz * rz)
    return (u >= 0) & (v >= 0) & (u + v <= 1.0) & (tmin <= t), t, u, v


def _check_table(ms, W):
    if ms.packed and W != PACKED_WIDTH[ms.packed]:
        raise ValueError(f"a format-{ms.packed} table has {PACKED_WIDTH[ms.packed]} columns, not {W}")
    if not ms.packed and W not in (16, 32):
        raise ValueError(f"the classic rows have 32 columns, or 16 (w16_rows), not {W}")
    if not ms.packed and W == 16 and not ms.analytic_mode:
        raise ValueError("the 16-column table holds triangle rows only (analytic mode)")


def walk_isolate_plain(ms, rows, o, d, *, test: bool = True, group: int = 1):
    """The closest-hit walk of rays o, d (3, N) f32 over ``rows`` (ms.rows,
    or ``w16_rows`` of classic rows), ``group`` rays walking as one packet;
    a packed table's prims by ``_packed_test``'s tournament. Returns (t,
    rows visited), each (N,) f32; counts the rows by kind as the
    megakernels' plain walk does (``mk.row_kinds``: interior rows, and prim
    rows under the table's format, 0 for the classic rows and w16)."""
    n, W = o.shape[1], rows.shape[1]
    _check_table(ms, W)
    ng = n // group
    tmin = f32(M_EPS)
    ox, oy, oz = (o[k].reshape(ng, group) for k in range(3))
    dx, dy, dz = (d[k].reshape(ng, group) for k in range(3))
    flat = lambda a: a.reshape(n)
    bt = torch.full((n,), f32(mk.BIG), device=o.device)
    for k in range(ms.n_analytic):  # the analytic pretest
        phit, pt, _, _ = mk._analytic_test(ms.analytic[k], (o[0], o[1], o[2]), (d[0], d[1], d[2]),
                                           tmin, bt)
        bt = torch.where(phit & (pt < bt), pt, bt)
    bt = bt.reshape(ng, group)
    ix, iy, iz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    tox, toy, toz = -ox * ix, -oy * iy, -oz * iz
    if ms.ntab == 1:
        base = torch.zeros(ng, dtype=torch.int64, device=o.device)
    else:  # each group's majority direction (a group of one: its own)
        vote = lambda c: (torch.where(c > 0, 1.0, -1.0).sum(1) > 0).long()
        base = (vote(dx) + 2 * vote(dy) + 4 * vote(dz)) * ms.tbl_rows
    cur, end = base, base + ms.tbl_rows
    nit = torch.zeros(ng, device=o.device)
    while True:
        act = cur < end
        if not bool(act.any()):
            break
        r = rows[torch.clamp_max(cur, rows.shape[0] - 1)]
        col = lambda j: r[:, j : j + 1]
        is_prim = r[:, 9] >= 0.0
        ax, bx = col(0) * ix + tox, col(3) * ix + tox
        ay, by = col(1) * iy + toy, col(4) * iy + toy
        az, bz = col(2) * iz + toz, col(5) * iz + toz
        t0 = torch.maximum(torch.maximum(torch.minimum(ax, bx), torch.minimum(ay, by)),
                           torch.minimum(az, bz))
        t1 = torch.minimum(torch.minimum(torch.maximum(ax, bx), torch.maximum(ay, by)),
                           torch.maximum(az, bz))
        slab = ((t0 < t1 + f32(M_EPS)) & (t0 < bt) & (t1 > tmin)).any(1)
        if test:
            r3 = r[:, :, None]  # r3[:, j]: column j as (groups, 1)
            if ms.packed:
                phit, pt, _, _, _ = mk._packed_test(ms.packed, r3, (ox, oy, oz), (dx, dy, dz), tmin)
            elif W == 16 or ms.analytic_mode:
                phit, pt, _, _ = _tri_test(r3, (ox, oy, oz), (dx, dy, dz), tmin, 11 if W == 16 else 29)
            else:
                phit, pt, _, _ = mk._prim_test(ms, r3, (ox, oy, oz), (dx, dy, dz), tmin, bt)
            accept = (act & is_prim)[:, None] & phit & (pt < bt)
            bt = torch.where(accept, pt, bt)
        nxt = torch.where(~is_prim & slab, cur + 1, r[:, 10].long())
        cur = torch.where(act, nxt, cur)
        nit = nit + act.to(torch.float32)
        # every ray of a group visits the group's row (mk.row_kinds)
        mk._count_rows("interior", (act & ~is_prim)[:, None].expand(ng, group))
        mk._count_rows(ms.packed, (act & is_prim)[:, None].expand(ng, group))
    return flat(bt), flat(nit[:, None].expand(ng, group))


def walk_isolate(ms, rows, o, d, *, test: bool = True, group: int = 1, iters: int = 1,
                 block: int = 128, occupancy: bool = False):
    """K10b on a CUDA tensor (group 1 or 32; ``iters`` walks per ray), the
    plain version on a CPU tensor. ``occupancy``: launch nothing, return
    the blocks an SM holds."""
    n, W = o.shape[1], rows.shape[1]
    if n % group:
        raise ValueError(f"{n} rays do not split into groups of {group}")
    if o.device.type != "cuda":
        return walk_isolate_plain(ms, rows, o, d, test=test, group=group)
    dev = o.device
    if group not in (1, 32) or (group == 32 and block % 32):
        raise ValueError(f"the kernel takes group 1 or 32 (got {group}, block {block})")
    _check_table(ms, W)
    check("rows", rows, torch.float32, (ms.total_rows, W), dev)
    mk.check_rows_aligned(rows)
    check("o", o, torch.float32, (3, n), dev)
    check("d", d, torch.float32, (3, n), dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    nit = torch.empty(n, dtype=torch.float32, device=dev)
    args = (rows, ms.consts, *mk._scene_args(ms), W, int(test), group, iters, o, d, n, block,
            t, nit)
    if occupancy:
        return call("walk_isolate", *args, occupancy=True)
    call("walk_isolate", *args)
    LAUNCHES[_LAUNCH_KEY[ms.packed]] += 1
    return t, nit


# the kernels whose packed instantiations run walk_packed and packed_test,
# by their mangled template arguments: K10b <kFmt, kTest, kG>; K1 and K4
# <kFmt, kSh, kCache>, each packed format with the occlusion cache off and
# on, and the classic rows with the dedicated PACKED3 shadow table
PACKED_FORMATS = (1, 3, 4, 12)
PACKED_KERNELS = {"walk_isolate_packed_kernel": [f"ILi{f}ELb{t}ELi{g}E" for f in PACKED_FORMATS
                                                 for t in (1, 0) for g in (1, 32)],
                  **{k: [f"ILi{f}ELb0ELb{c}E" for f in PACKED_FORMATS for c in (0, 1)]
                     + ["ILi0ELb1ELb0E"] for k in ("mk_start_kernel", "mk_start_chained_kernel")}}


def walk_loops(code, loops) -> list:
    """The walk loops of a kernel's SASS (``sass_functions``' code and
    loops): a loop is a branch target and its furthest backward branch (the
    back edges of one head together), and a walk loop one that holds a
    128-bit LDG (the row step) and holds no other such loop."""
    ends = {}
    for start, end in loops:
        ends[start] = max(end, ends.get(start, end))
    wide = [j for j, (op, _) in enumerate(code) if op.startswith("LDG.") and ".128" in op]
    rows = [(a, b) for a, b in ends.items() if any(a <= j <= b for j in wide)]
    return [(a, b) for a, b in rows
            if not any((c, d) != (a, b) and a <= c and d <= b for c, d in rows)]


def check_packed_loads(lib=None, hold: bool = True) -> dict:
    """The loads of every packed walk (``PACKED_KERNELS``) in the SASS of
    the kernel library ``lib`` (the package's build by default): {(kernel,
    mangled template arguments): (128-bit LDGs, narrower LDGs in its walk
    loops (``walk_loops``), LDL/STL in its walk loops, LDL/STL in all)}.
    Raises RuntimeError where an instantiation is missing or has no walk
    loop, or, with ``hold``, has an LDL or STL in a walk loop: a spill of
    the walk's own values into local memory (the kernels' frames lie
    outside their walk loops)."""
    from hijiki_tpu_torch.probes import sass_functions

    out, bad = {}, []
    every = sass_functions("_kernel", lib)  # one cuobjdump for the three kernels
    for kernel, targs in PACKED_KERNELS.items():
        for t in targs:
            frag = f"{len(kernel)}{kernel}{t}E"
            found = [v for f, v in every.items() if frag in f]
            if not found:
                bad.append(f"no {kernel}{t} in the SASS")
                continue
            code, loops, _ = found[0]
            walks = walk_loops(code, loops)
            inside = [code[j] for a, b in walks for j in range(a, b + 1)]
            wide = sum(op.startswith("LDG.") and ".128" in op for op, _ in code)
            narrow = sum(op.startswith("LDG.") and ".128" not in op for op, _ in inside)
            local = sum(op.startswith(("LDL", "STL")) for op, _ in inside)
            out[(kernel, t)] = (wide, narrow, local,
                                sum(op.startswith(("LDL", "STL")) for op, _ in code))
            if not walks or (hold and local):
                bad.append(f"{kernel}{t}: {len(walks)} walk loops, {local} LDL/STL in them")
    if bad:
        raise RuntimeError("the packed walks' loads: " + "; ".join(bad))
    return out


def warp_rows(nit) -> tuple[float, float]:
    """(sum over warps of 32 x the warp's most rows visited, the longest
    warp's rows): a warp of 32 rays that walk alone runs for its longest
    ray, so the sum against the rows its rays visit measures divergence."""
    w = nit[: nit.numel() // 32 * 32].reshape(-1, 32).max(1).values
    return float(w.sum()) * 32, float(w.max())


def main(argv=None) -> int:
    from hijiki_tpu_torch.probes import timing

    argv = list(sys.argv[1:] if argv is None else argv)
    widths = bool(argv) and argv[0] == "widths"
    ap = parser(__doc__)
    ap.add_argument("W", nargs="?", type=int, default=1024,
                    help="camera frame W x W (the tool's image size)")
    ap.add_argument("--variants", nargs="+", choices=list(VARIANTS),
                    default=list(WIDTHS if widths else MAIN_VARIANTS))
    ap.add_argument("--rays", nargs="+", default=["camera", "random"], choices=("camera", "random"))
    args = ap.parse_args(argv[1:] if widths else argv)
    dev = device_of(args)
    tables, cs = load_tables(SCENE, dev, {VARIANTS[v][0] for v in args.variants}, args.W)
    if widths:
        return main_widths(args, dev, tables, cs)
    results = []
    if dev.type != "cuda":
        for rays in args.rays:
            o, d = ray_set(rays, cs, args.W * args.W, dev, frame=args.W)
            for name in args.variants:
                for g in GROUPS:
                    table, test = VARIANTS[name]
                    ms, rows = tables[table]
                    t, nit = walk_isolate(ms, rows, o, d, test=test, group=g)
                    print(f"{rays:6s} {name:15s} G={g:2d}: plain version on the CPU (not timed), "
                          f"{float((t < 1e30).float().mean()):.4f} hit, "
                          f"{float(nit.mean()):.2f} rows visited per ray")
        return 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"# {card()}; {', '.join(f'{k} {v[1].shape[0]} x {v[1].shape[1]}' for k, v in tables.items())} "
          f"table rows; {sms} SMs", flush=True)
    step_ns = {}  # one warp per SM: ns a warp-step, the exposed latency
    for rays in args.rays:
        for occ, threads, block in occupancies(dev):
            o, d = ray_set(rays, cs, threads, dev, frame=args.W)
            for name in args.variants:
                table, test = VARIANTS[name]
                ms, rows = tables[table]
                for g in GROUPS:
                    t, nit = walk_isolate(ms, rows, o, d, test=test, group=g, block=block)
                    res = timing.slope(lambda it: walk_isolate(ms, rows, o, d, test=test, group=g,
                                                               iters=it, block=block))
                    steps, longest = warp_rows(nit)
                    rows_total = float(nit.sum())
                    res.update(probe="walk_isolate", variant=name, group=g, rays=rays, occupancy=occ,
                               threads=threads, block=block, rows_per_ray=rows_total / threads,
                               warp_steps_per_ray=steps / threads, longest_warp_rows=longest,
                               hit_share=float((t < 1e30).float().mean()),
                               blocks_per_sm=walk_isolate(ms, rows, o, d, test=test, group=g,
                                                          block=block, occupancy=True))
                    # one warp per SM: each trip an SM's warp walks another
                    # warp's rays, so over the trips it runs for the mean of the
                    # warps' longest rays (warp steps a ray); full: the walk's
                    # time per row visited
                    res["ns_per_row_step"] = (res["ns_per_iter"] * threads / steps if occ == "warp"
                                              else res["ns_per_iter"] / rows_total)
                    line = (f"{rays:6s} {occ:4s} {name:15s} G={g:2d}: {res['ns_per_iter'] / 1e3:9.3f} "
                            f"us/walk (lo {res['t_lo_ms']:.3f} ms x{res['lo']}, hi {res['t_hi_ms']:.3f} "
                            f"ms), {res['rows_per_ray']:7.2f} rows/ray, warp steps/ray "
                            f"{res['warp_steps_per_ray']:7.2f}, longest warp {longest:.0f}, "
                            f"{res['ns_per_row_step']:9.4f} ns/row-step, hit {res['hit_share']:.4f}")
                    key = (rays, name, g)
                    if occ == "warp":
                        step_ns[key] = res["ns_per_row_step"]
                    elif key in step_ns:
                        # an SM's warp-steps (each warp runs for its longest ray)
                        # against its time, and Little's law with the resident warps
                        warps = steps / 32
                        resident = res["blocks_per_sm"] * block // 32
                        res["ns_per_warp_step_sm"] = res["ns_per_iter"] * sms / warps
                        res["little"] = timing.little(step_ns[key] * warps / (threads // 32),
                                                      res["ns_per_iter"], threads // 32, sms,
                                                      resident)
                        line += (f"; {res['ns_per_warp_step_sm']:.2f} ns a warp-step an SM, "
                                 f"{resident} warps/SM resident, Little's-law share {res['little']:.3f}")
                    print(line, flush=True)
                    results.append(res)
    # the tool's summary: the prim test's share of a row step (1M threads, G = 1)
    full = {(r["rays"], r["variant"]): r["ns_per_row_step"] for r in results
            if r["occupancy"] == "full" and r["group"] == 1}
    for (rays, name), ns in full.items():
        if name.endswith("-notest") or (rays, name + "-notest") not in full:
            continue
        bare = full[(rays, name + "-notest")]
        print(f"{rays:6s} per row step: {name} {ns:.4f} ns, no-test {bare:.4f} ns -> "
              f"test share {(ns - bare) / ns * 100:.0f}%")
    dump(args, results)
    return 0


def main_widths(args, dev, tables, cs) -> int:
    """The tool's main_widths: one closest-hit walk of the W x W camera frame
    over each table (G = 1), on the card timed in turns (the best of 7 CUDA
    event times), with rows per ray and the t sum of the hits."""
    o, d = ray_set("camera", cs, args.W * args.W, dev, frame=args.W)
    runs, stats = {}, {}
    for name in args.variants:
        table, test = VARIANTS[name]
        ms, rows = tables[table]
        runs[name] = lambda ms=ms, rows=rows, test=test: walk_isolate(ms, rows, o, d, test=test)
        t, nit = runs[name]()
        stats[name] = (float(nit.mean()), float(torch.where(t < 1e30, t, 0.0).double().sum()))
    if dev.type != "cuda":
        for name, (rows_ray, tsum) in stats.items():
            print(f"{name:12s}: plain version on the CPU (not timed), {rows_ray:7.2f} rows/ray, "
                  f"t-sum {tsum:.1f}")
        return 0
    print(f"# {card()}; widths: {args.W}x{args.W} camera rays, G = 1", flush=True)
    times = {name: [] for name in runs}
    for _ in range(7):
        for name, run in runs.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            b.synchronize()
            times[name].append(a.elapsed_time(b))
    base = min(times[args.variants[0]])
    results = []
    for name in runs:
        best = min(times[name])
        rows_ray, tsum = stats[name]
        ms, rows = tables[VARIANTS[name][0]]
        print(f"{name:12s}: {best:8.4f} ms  {rows.shape[0]:6d} x {rows.shape[1]:3d} rows  "
              f"rows/ray {rows_ray:7.2f}  t-sum {tsum:14.1f}  vs {args.variants[0]}: "
              f"{base / best:.3f}x", flush=True)
        results.append(dict(probe="walk_isolate", mode="widths", variant=name, ms=best,
                            ms_all=times[name], rows_per_ray=rows_ray, t_sum=tsum,
                            table_rows=rows.shape[0], row_floats=rows.shape[1],
                            speed_vs_first=base / best))
    dump(args, results)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
