"""K10b: the walk-isolation probe on the H100.

Counterpart of tools/walk_probe.py (``walk_kernel``/``make_runner``,
pallas_call at :84; ``patch_no_test`` :178; ``make_w16_scene`` and
``patch_normals_at_11`` :133-175). The render kernels' own closest-hit walk
(csrc/walk.cuh: the analytic pretest, then the walk from the octant table of
the ray's direction, stopped before the winner resolve) on camera or random
rays, outside the bounce loop; out: t and the rows visited per ray.

* ``walk_isolate_plain``: the plain version (any device): a lockstep walk of
  groups of ``group`` rays; ``group = 1`` is the render kernels' per-ray
  walk (ops/megakernel.py::_walk), ``group = 32`` a 32-ray packet (the
  octant table of the packet's majority direction, descend when any ray's
  slab test passes, accept per ray).
* ``walk_isolate``: the CUDA kernel on a CUDA tensor, the plain version on a
  CPU tensor. ``iters`` is the slope method's trip count: trip k walks ray
  i + 2144 k (mod n) in thread i, so no trip finds the rows of the trip
  before in L1, and the last walks ray i (the result is the same).

Variants: ``test``/``notest`` (every prim row misses, the tool's
patch_no_test) x ``w32``/``w16`` (``w16_rows``: columns 0-10 and the plane
normal in 11-13). t equals the JAX tool's up to the FMA/t-tie class; the
JAX walk counts packet unions, so its rows visited are not compared. The
tool's packed/pack3/pack4/slim tables are not ported (Queue 2 item 5).

Usage (the tool's image size; on the card G = 1 and 32 take the place of
its groups):

    python -m hijiki_tpu_torch.probes.walk_probe [W] [--variants w32 ...]
        [--rays camera random] [--device cuda|cpu] [--json out.json]
"""

from __future__ import annotations

import math

import numpy as np
import torch

from hijiki_tpu_torch.ops import megakernel as mk
from hijiki_tpu_torch.probes import (GROUPS, SCENE, call, card, check, device_of, dump, f32,
                                     occupancies, parser)

M_EPS = 1e-4
VARIANTS = {"w32": (32, True), "w32-notest": (32, False), "w16": (16, True),
            "w16-notest": (16, False)}

# launches of the CUDA kernel (CPU calls of the plain version are not counted)
LAUNCHES = {"walk_isolate": 0}


def load_scene(path: str, device, width: int = 1024, height: int = 1024):
    """The port's scene (OBJ with the cbox spheres, as chip_smoke.py uses
    it) baked for the walk: (MegaScene, CompiledScene)."""
    from hijiki_tpu_torch.scene.compile import compile_scene
    from hijiki_tpu_torch.scene.obj import load_obj_scene

    scene = load_obj_scene(path)
    scene.put_cbox_spheres()
    cs = compile_scene(scene)
    return mk.mega_scene(cs, width, height, device), cs


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


def walk_isolate_plain(ms, rows, o, d, *, test: bool = True, group: int = 1):
    """The closest-hit walk of rays o, d (3, N) f32 over ``rows`` (ms.rows,
    or ``w16_rows`` of it), ``group`` rays walking as one packet. Returns
    (t, rows visited), each (N,) f32."""
    n, W = o.shape[1], rows.shape[1]
    if W == 16 and not ms.analytic_mode:
        raise ValueError("the 16-column table holds triangle rows only (analytic mode)")
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
            if W == 16 or ms.analytic_mode:
                phit, pt, _, _ = _tri_test(r3, (ox, oy, oz), (dx, dy, dz), tmin, 11 if W == 16 else 29)
            else:
                phit, pt, _, _ = mk._prim_test(ms, r3, (ox, oy, oz), (dx, dy, dz), tmin, bt)
            accept = (act & is_prim)[:, None] & phit & (pt < bt)
            bt = torch.where(accept, pt, bt)
        nxt = torch.where(~is_prim & slab, cur + 1, r[:, 10].long())
        cur = torch.where(act, nxt, cur)
        nit = nit + act.to(torch.float32)
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
    if group not in (1, 32) or (group == 32 and block % 32) or W not in (16, 32):
        raise ValueError(f"the kernel takes group 1 or 32 and 16 or 32 columns "
                         f"(got {group}, block {block}, {W})")
    if W == 16 and not ms.analytic_mode:
        raise ValueError("the 16-column table holds triangle rows only (analytic mode)")
    check("rows", rows, torch.float32, (ms.total_rows, W), dev)
    check("o", o, torch.float32, (3, n), dev)
    check("d", d, torch.float32, (3, n), dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    nit = torch.empty(n, dtype=torch.float32, device=dev)
    args = (rows, ms.consts, *mk._scene_args(ms), W, int(test), group, iters, o, d, n, block,
            t, nit)
    if occupancy:
        return call("walk_isolate", *args, occupancy=True)
    call("walk_isolate", *args)
    LAUNCHES["walk_isolate"] += 1
    return t, nit


def warp_rows(nit) -> tuple[float, float]:
    """(sum over warps of 32 x the warp's most rows visited, the longest
    warp's rows): a warp of 32 rays that walk alone runs for its longest
    ray, so the sum against the rows its rays visit measures divergence."""
    w = nit[: nit.numel() // 32 * 32].reshape(-1, 32).max(1).values
    return float(w.sum()) * 32, float(w.max())


def main(argv=None) -> int:
    from hijiki_tpu_torch.probes import timing

    ap = parser(__doc__)
    ap.add_argument("W", nargs="?", type=int, default=1024,
                    help="camera frame W x W (the tool's image size)")
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    ap.add_argument("--rays", nargs="+", default=["camera", "random"], choices=("camera", "random"))
    args = ap.parse_args(argv)
    dev = device_of(args)
    ms, cs = load_scene(SCENE, dev, args.W, args.W)
    tables = {32: ms.rows, 16: w16_rows(ms.rows).contiguous()}
    results = []
    if dev.type != "cuda":
        for rays in args.rays:
            o, d = ray_set(rays, cs, args.W * args.W, dev, frame=args.W)
            for name in args.variants:
                for g in GROUPS:
                    W, test = VARIANTS[name]
                    t, nit = walk_isolate(ms, tables[W], o, d, test=test, group=g)
                    print(f"{rays:6s} {name:10s} G={g:2d}: plain version on the CPU (not timed), "
                          f"{float((t < 1e30).float().mean()):.4f} hit, "
                          f"{float(nit.mean()):.2f} rows visited per ray")
        return 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"# {card()}; {ms.total_rows} table rows; {sms} SMs", flush=True)
    step_ns = {}  # one warp per SM: ns a warp-step, the exposed latency
    for rays in args.rays:
        for occ, threads, block in occupancies(dev):
            o, d = ray_set(rays, cs, threads, dev, frame=args.W)
            for name in args.variants:
                W, test = VARIANTS[name]
                for g in GROUPS:
                    t, nit = walk_isolate(ms, tables[W], o, d, test=test, group=g, block=block)
                    res = timing.slope(lambda it: walk_isolate(ms, tables[W], o, d, test=test, group=g,
                                                               iters=it, block=block))
                    steps, longest = warp_rows(nit)
                    rows_total = float(nit.sum())
                    res.update(probe="walk_isolate", variant=name, group=g, rays=rays, occupancy=occ,
                               threads=threads, block=block, rows_per_ray=rows_total / threads,
                               warp_steps_per_ray=steps / threads, longest_warp_rows=longest,
                               hit_share=float((t < 1e30).float().mean()),
                               blocks_per_sm=walk_isolate(ms, tables[W], o, d, test=test, group=g,
                                                          block=block, occupancy=True))
                    # one warp per SM: each trip an SM's warp walks another
                    # warp's rays, so over the trips it runs for the mean of the
                    # warps' longest rays (warp steps a ray); full: the walk's
                    # time per row visited
                    res["ns_per_row_step"] = (res["ns_per_iter"] * threads / steps if occ == "warp"
                                              else res["ns_per_iter"] / rows_total)
                    line = (f"{rays:6s} {occ:4s} {name:10s} G={g:2d}: {res['ns_per_iter'] / 1e3:9.3f} "
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
    dump(args, results)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
