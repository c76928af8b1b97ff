"""K10a: the walker-body ablation probe on the H100.

Counterpart of tools/ablate_walker.py (``_body_kernel``/``run_variant``,
pallas_call at :187; ``VARIANTS`` at :210). A fixed-trip clone of the
walker body whose cursor follows the real table's exit pointers (wrapped at
the end), with six parts switched per variant, so the slope of each
variant's time prices one part of a walk step (see csrc/probe_walk.cu).

* ``walk_ablate_plain``: the plain version (any device). ``group`` rays
  share a cursor: consecutive rays of the channel-major (3, N) layout. With
  the TPU's (n_tiles, 3, 8, P) blocks flattened by ``lanes_of`` and
  ``group = P``, it computes what the JAX kernel computes.
* ``walk_ablate``: the CUDA kernel on a CUDA tensor (``group`` 1 or 32),
  the plain version on a CPU tensor.

At ``group = 1`` the ``noreduce`` variant is the same program as ``full``
(one ray votes alone).

Usage (the tool's arguments; ``iters`` is the low trip count, the high one
3x, and 0 lets the harness calibrate it; on the card the rays are the
occupancy's threads, walked at G = 1 and 32 in place of the packet P, which
sizes the CPU run's one tile of 8 x P rays):

    python -m hijiki_tpu_torch.probes.ablate_walker [iters|0] [P] [variant ...]
        [--rays random camera] [--device cuda|cpu] [--json out.json]
"""

from __future__ import annotations

import numpy as np
import torch

from hijiki_tpu_torch.probes import (GROUPS, SCENE, call, card, check, device_of, dump, f32,
                                     occupancies, parser)

M_EPS = 1e-4
BIG = 3.0e38
SUBLANES = 8
# the parts of the walker body, in the order of their flag bits
PARTS = ("fetch", "prefetch", "slab", "reduce", "prim", "count")
VARIANTS = {
    "full": {},
    "nocount": dict(count=False),
    "noreduce": dict(reduce=False),
    "noprim": dict(prim=False),
    "noslab": dict(slab=False),
    "noprefetch": dict(prefetch=False),
    "nofetch": dict(fetch=False),
    "onlyfetch": dict(slab=False, prim=False, reduce=False, count=False),
    "onlyloop": dict(fetch=False, slab=False, prim=False, reduce=False, count=False),
    "nofetch_noreduce": dict(fetch=False, reduce=False),
    "noprim_noreduce": dict(prim=False, reduce=False),
}

# launches of the CUDA kernel (CPU calls of the plain version are not counted)
LAUNCHES = {"walk_ablate": 0}


def variant_flags(cfg: dict) -> int:
    """The kernel's flag bits of a VARIANTS entry (every part on by default)."""
    return sum(1 << k for k, p in enumerate(PARTS) if cfg.get(p, True))


def lanes_of(a: np.ndarray) -> np.ndarray:
    """The TPU's (n_tiles, C, 8, P) blocks as channel-major (C, N) lanes."""
    return np.ascontiguousarray(a.transpose(1, 0, 2, 3).reshape(a.shape[1], -1))


def walk_ablate_plain(rows, o, d, iters: int, cfg: dict, group: int):
    """The walker body for ``iters`` steps over the trace rows ``rows``
    (R, 32) f32 for rays o, d (3, N) f32, ``group`` rays a cursor. Returns
    (2, N) f32: min(t, 1e6) + visits + u, and min(winner row, 1e6) + cursor."""
    fetch_on, prefetch = cfg.get("fetch", True), cfg.get("prefetch", True)
    slab_on, reduce_on = cfg.get("slab", True), cfg.get("reduce", True)
    prim_on, count_on = cfg.get("prim", True), cfg.get("count", True)
    R, n = rows.shape[0], o.shape[1]
    ng = n // group
    ox, oy, oz = (o[k].reshape(ng, group) for k in range(3))
    dx, dy, dz = (d[k].reshape(ng, group) for k in range(3))
    tmin = f32(M_EPS)
    ix, iy, iz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    tox, toy, toz = -ox * ix, -oy * iy, -oz * iz

    def fetch(c):
        return rows[torch.clamp_max(c, R - 1)]

    cur = torch.zeros(ng, dtype=torch.int64, device=o.device)
    row = fetch(cur)
    t = torch.full_like(ox, f32(BIG)) + ox * 0.0
    u, v, nit = ox * 0.0, ox * 0.0, ox * 0.0
    wrow = torch.full(ox.shape, R, dtype=torch.int64, device=o.device)
    for _ in range(iters):
        if fetch_on and not prefetch:
            row = fetch(cur)
        col = lambda j: row[:, j : j + 1]  # (ng, 1): the group's row
        nexit = row[:, 10].long()
        if fetch_on and prefetch:
            fa, fb = fetch(cur + 1), fetch(nexit)
        is_prim = row[:, 9] >= 0.0
        best_t = t
        if slab_on:
            ax, bx = col(0) * ix + tox, col(3) * ix + tox
            ay, by = col(1) * iy + toy, col(4) * iy + toy
            az, bz = col(2) * iz + toz, col(5) * iz + toz
            t0 = torch.maximum(torch.maximum(torch.minimum(ax, bx), torch.minimum(ay, by)),
                               torch.minimum(az, bz))
            t1 = torch.minimum(torch.minimum(torch.maximum(ax, bx), torch.maximum(ay, by)),
                               torch.maximum(az, bz))
            slab = (t0 < t1 + f32(M_EPS)) & (t0 < best_t) & (t1 > tmin)
        else:
            slab = torch.zeros(ox.shape, dtype=torch.bool, device=o.device)
        if reduce_on:
            descend = (slab & ~is_prim[:, None]).any(1)
        else:
            descend = slab[:, 0] & ~is_prim
        if prim_on:
            rx, ry, rz = ox - col(0), oy - col(1), oz - col(2)
            qx = ry * dz - rz * dy
            qy = rz * dx - rx * dz
            qz = rx * dy - ry * dx
            dd = 1.0 / (dx * col(29) + dy * col(30) + dz * col(31))
            pu = -dd * (qx * col(6) + qy * col(7) + qz * col(8))
            pv = dd * (qx * col(3) + qy * col(4) + qz * col(5))
            t_pq = -dd * (col(29) * rx + col(30) * ry + col(31) * rz)
            in_tri = (pu >= 0) & (pv >= 0) & (pu + pv <= 1.0)
            ok_pq = in_tri & (tmin <= t_pq) & (t_pq <= best_t)
            accept = is_prim[:, None] & ok_pq & (t_pq < best_t)
            t = torch.where(accept, t_pq, t)
            u = torch.where(accept, pu, u)
            v = torch.where(accept, pv, v)
            wrow = torch.where(accept, cur[:, None], wrow)
        take_exit = is_prim | ~descend
        nxt = torch.where(take_exit, nexit, cur + 1)
        cur = torch.where(nxt >= R, nxt - R, nxt)
        if fetch_on and prefetch:
            row = torch.where(take_exit[:, None], fb, fa)
        if count_on:
            nit = nit + 1.0
    out0 = torch.clamp_max(t, f32(1e6)) + nit + u
    out1 = torch.clamp_max(wrow.to(torch.float32), f32(1e6)) + cur.to(torch.float32)[:, None]
    return torch.stack([out0.reshape(n), out1.reshape(n)])


def walk_ablate(rows, o, d, iters: int, cfg: dict, group: int = 1, *, block: int = 128,
                occupancy: bool = False):
    """K10a on a CUDA tensor (group 1 or 32), the plain version on a CPU
    tensor. ``occupancy``: launch nothing, return the blocks an SM holds."""
    n = o.shape[1]
    if n % group:
        raise ValueError(f"{n} rays do not split into groups of {group}")
    if o.device.type != "cuda":
        return walk_ablate_plain(rows, o, d, iters, cfg, group)
    dev = o.device
    if group not in (1, 32) or (group == 32 and block % 32):
        raise ValueError(f"the kernel takes group 1 or 32 (got {group}, block {block})")
    check("rows", rows, torch.float32, (rows.shape[0], 32), dev)
    check("o", o, torch.float32, (3, n), dev)
    check("d", d, torch.float32, (3, n), dev)
    out = torch.empty((2, n), dtype=torch.float32, device=dev)
    args = (rows, rows.shape[0], o, d, n, iters, variant_flags(cfg), group, block, out)
    if occupancy:
        return call("walk_ablate", *args, occupancy=True)
    call("walk_ablate", *args)
    LAUNCHES["walk_ablate"] += 1
    return out


def tool_rays(n_tiles: int, packet: int, seed: int = 0):
    """The JAX tool's rays: origins uniform in [-1, 1]^3, normal directions
    normalized (components below 1e-6 set to 1e-6), in its (n_tiles, 3, 8,
    P) blocks; as numpy f32."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1, 1, (n_tiles, 3, SUBLANES, packet)).astype(np.float32)
    d = rng.normal(size=(n_tiles, 3, SUBLANES, packet)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-9
    d = np.where(np.abs(d) < 1e-6, 1e-6, d).astype(np.float32)
    return o, d


def main(argv=None) -> int:
    from hijiki_tpu_torch.probes import timing
    from hijiki_tpu_torch.probes.walk_probe import load_scene, ray_set

    ap = parser(__doc__)
    ap.add_argument("iters", nargs="?", type=int, default=0)
    ap.add_argument("packet", nargs="?", type=int, default=1024)
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--rays", nargs="+", default=["random"], choices=("random", "camera"))
    args = ap.parse_args(argv)
    dev = device_of(args)
    ms, cs = load_scene(SCENE, dev)
    rows = ms.rows
    results = []
    if dev.type != "cuda":
        o, d = (torch.from_numpy(lanes_of(a)) for a in tool_rays(1, args.packet))
        for name in args.variants:
            for g in GROUPS:
                out = walk_ablate(rows, o, d, args.iters or 20, VARIANTS[name], g)
                print(f"{name:18s} G={g:2d}: plain version on the CPU (not timed), "
                      f"sums {float(out[0].sum()):.6e} {float(out[1].sum()):.6e}")
        return 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"# {card()}; {rows.shape[0]} table rows; {sms} SMs", flush=True)
    warp_ns = {}  # one warp per SM: ns a step, the exposed latency
    for rays in args.rays:
        for occ, threads, block in occupancies(dev):
            o, d = ray_set(rays, cs, threads, dev)
            for g in GROUPS:
                full_ns = None
                for name in args.variants:
                    cfg = VARIANTS[name]
                    res = timing.slope(lambda it: walk_ablate(rows, o, d, it, cfg, g, block=block),
                                       lo=args.iters or None, hi=3 * args.iters or None)
                    res.update(probe="walk_ablate", variant=name, group=g, rays=rays,
                               occupancy=occ, threads=threads, block=block,
                               blocks_per_sm=walk_ablate(rows, o, d, 1, cfg, g, block=block,
                                                         occupancy=True))
                    res["ns_per_lane_step"] = res["ns_per_iter"] / threads
                    full_ns = res["ns_per_iter"] if name == "full" else full_ns
                    delta = "" if full_ns is None else f"  delta {full_ns - res['ns_per_iter']:+.1f} ns"
                    line = (f"{rays:6s} {occ:4s} G={g:2d} {name:18s} lo {res['t_lo_ms']:8.3f} ms  "
                            f"hi {res['t_hi_ms']:8.3f} ms  slope {res['ns_per_iter']:9.3f} ns/iter  "
                            f"{res['ns_per_lane_step'] * 1e3:9.4f} ps/lane-step{delta}")
                    key = (rays, g, name)
                    if occ == "warp":
                        warp_ns[key] = res["ns_per_iter"]
                    elif key in warp_ns and res["ns_per_iter"] > 0:
                        resident = res["blocks_per_sm"] * block // 32
                        res["little"] = timing.little(warp_ns[key], res["ns_per_iter"],
                                                      threads // 32, sms, resident)
                        line += f"; {resident} warps/SM resident, Little's-law share {res['little']:.3f}"
                    print(line, flush=True)
                    results.append(res)
    dump(args, results)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
