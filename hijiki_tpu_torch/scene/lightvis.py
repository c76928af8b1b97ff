"""Shadow-visibility boxes: a compile-time proof that a region sees the light.

Port of ``hijiki_tpu/scene/lightvis.py`` (numpy, the same proof and the
same boxes; the disk cache lives under the port's own ``build/lightvis/``).

The megakernel's NEE shadow walk mostly proves misses for unoccluded
lanes. This module proves, per spatial cell of a grid over the scene AABB,
at scene compile time, that NO primitive can block ANY shadow ray from the
cell to the emitters, then compresses the proven cells into a handful of
axis-aligned world-space boxes. A lane whose NEE origin lies inside any
box skips the any-hit walk with visibility 1 — exactly (the walk would
have returned "unoccluded" bitwise): only rays the proof covers are
skipped, everything else walks as before.

Soundness argument (conservative at every step; ``shader/scene.glsl:79-89``
semantics — the walk tests occluders at ``t in [2*eps, dist-eps]`` with
``eps = M_EPS = 1e-4`` absolute, the megakernel's shadow walk):

* Proof region per cell = the cell dilated by ``eps_out`` on every face.
  Membership in the kernel is a closed f32 box compare on the UNDILATED
  cell bounds, so every accepted origin is strictly inside the proof
  region with ``eps_out`` to spare. The dilation exists because hit points
  are computed as ``o + t*d`` in f32 and can land ~1e-6*scale off their
  true surface — including just OUTSIDE the scene AABB; the grid's outer
  faces coincide with the AABB exactly (no padding — padding is what made
  an earlier draft prove only empty-air cells), and boundary boxes are
  extended outward by ``eps_out`` to catch those stragglers.
* The set of shadow segments from the (dilated) cell C to the emitters is
  contained in the convex hull ``H = hull(C u E)`` where E is the padded
  AABB of all emitter sampling geometry. ``H`` is the union over
  ``t in [0,1]`` of the boxes ``L(t) = (1-t)*C + t*E``, so "prim AABB T
  overlaps H" reduces per axis to a linear inequality in ``t``; a prim
  whose AABB misses H can never occlude (exact box-vs-hull test; T
  containing the prim keeps it conservative).
* A PLANAR prim q (triangle/quad) that overlaps H is still harmless when
  the dilated cell and all emitter vertices lie on one CLOSED half-space
  of q's plane: a segment with both endpoints in a closed half-space
  touches the plane only at its endpoints — t=0 (below the walk's 2*eps
  floor) or t=dist (beyond the dist-eps cap). This is what lets cells
  resting ON the floor/walls be proven despite containing their own
  supporting geometry.
* Straddle tolerance: a dilated cell that pokes through q's plane by
  ``h <= -d_lo`` (d_lo = its min signed distance) is STILL harmless when
  every cell-to-light direction makes angle ``cos >= (lmin - d_hi)/maxdist``
  with q's normal large enough that the single plane crossing happens at
  ``t <= h/cos <= T_BUDGET < 2*eps``: the crossing sits below the walk's
  own t-floor, so the walk itself would ignore it. T_BUDGET = 1e-4 leaves
  a 2x margin under the 2e-4 floor for the prim test's f32 rounding of t.
  (The cos bound is per cell: numerator = min over corner pairs of
  ``(l - o) . n`` = lmin - cell_dmax, denominator = max corner-pair
  distance.) Without this, the f32-slop dilation would unprove exactly
  the boundary cells the feature exists for.
* A prim coplanar with ALL emitter vertices (|ldist| <= tol everywhere,
  e.g. the emitter's own faces) can only meet a shadow segment at its
  t=dist endpoint — beyond the dist-eps cap — so it is harmless for every
  cell regardless of position.
* Spheres get no planar refinement: any hull overlap marks the cell
  unproven. Sphere EMITTERS disable the whole grid (their sample set is
  not enclosed by a plane-friendly vertex hull and area sampling covers
  the far side; returns None).

All plane-side arithmetic runs in float64 on the exact f32 inputs. The
final artifact is a tuple of <= MAX_BOXES axis-aligned boxes (6 floats
each) found by greedy grow-and-cover over the proven cells; the kernel
tests membership with pure f32 compares, ~12 operations per box once per
bounce.
"""

from __future__ import annotations

import numpy as np

GRID_TARGET = 8192  # proof cells (granularity only — boxes are the output)
MAX_BOXES = 16
MAX_PRIMS = 32768  # skip the build on larger scenes (O(cells*prims) sweep)
T_BUDGET = 1e-4  # max tolerated sub-floor plane-crossing t (2x under 2*M_EPS)
_REL_TOL = 1e-12  # strict plane-side tolerance, relative to scene scale
_REL_EPS_OUT = 2e-6  # proof dilation: ~10x the observed f32 hit-point slop
_MIN_COVER = 0.02  # give up if boxes cover < 2% of cells (lookup not worth it)
_CACHE_VERSION = 1  # bump on any semantic change to the proof


def _cache_dir():
    import os

    d = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "build", "lightvis",
    )
    os.makedirs(d, exist_ok=True)
    return d


def _cache_key(aabb_min, aabb_max, kind, a, b, c, E, target) -> str:
    import hashlib

    h = hashlib.sha256()
    h.update(f"v{_CACHE_VERSION}:{target}:{MAX_BOXES}:".encode())
    for arr in (aabb_min, aabb_max, kind, a, b, c, E):
        x = np.ascontiguousarray(arr)
        h.update(str(x.dtype).encode())
        h.update(str(x.shape).encode())
        h.update(x.tobytes())
    return h.hexdigest()


def _cache_load(key: str):
    """() stored = proven-nothing; None = cache miss."""
    import os

    path = os.path.join(_cache_dir(), key + ".npy")
    try:
        flat = np.load(path)
    except (OSError, ValueError):
        return None
    if flat.size == 0:
        return ()
    return (int(flat[0]),) + tuple(float(v) for v in flat[1:])


def _cache_store(key: str, result):
    import os

    path = os.path.join(_cache_dir(), key + ".npy")
    tmp = path + f".{os.getpid()}.tmp.npy"  # .npy suffix: np.save appends
    try:
        np.save(tmp, np.asarray(result if result else [], np.float64))
        os.replace(tmp, path)
    except OSError:
        pass
    return result


def _axis_dims(extent: np.ndarray, target: int = GRID_TARGET):
    """Grid dims roughly proportional to extent with nx*ny*nz <= target,
    each in [1, 256] (robust to degenerate/planar extents)."""
    e = np.asarray(extent, np.float64)
    e = np.maximum(e, 1e-6 * max(e.max(), 1e-30))  # relative floor
    k = (target / e.prod()) ** (1.0 / 3.0)
    dims = np.clip(np.floor(e * k).astype(np.int64), 1, 256)
    while dims.prod() > target:  # clamping can overshoot; halve the largest
        i = int(np.argmax(dims))
        dims[i] = max(1, dims[i] // 2)
    return tuple(int(v) for v in dims)


def build_shadow_vis_boxes(
    aabb_min: np.ndarray,  # (N,3) f32 per-prim AABBs (all prims)
    aabb_max: np.ndarray,
    kind: np.ndarray,  # (N,) i32 KIND_* per prim
    prim_a: np.ndarray,  # (N,3) sphere center / quad origin / tri v0
    prim_b: np.ndarray,  # (N,3) (radius,0,0) / edge1 / edge ab
    prim_c: np.ndarray,  # (N,3) 0 / edge2 / edge ac
    emitter_shape: np.ndarray,  # (E,) global shape indices of emitters
    kind_sphere: int,
    kind_quad: int,
    kind_tri: int,
    target: int = GRID_TARGET,
) -> tuple | None:
    """Returns a flat static tuple (K, x0,y0,z0,x1,y1,z1, ...) of proven
    boxes, or None when nothing useful can be proven."""
    E = np.asarray(emitter_shape, np.int64).reshape(-1)
    if E.size == 0:
        return None
    kind = np.asarray(kind, np.int64).reshape(-1)
    if np.any(kind[E] == kind_sphere):
        return None
    if len(kind) > MAX_PRIMS:
        # the cell sweep is O(cells * prims): skip very large scenes, as
        # the reference does
        return None

    key = _cache_key(
        aabb_min, aabb_max, kind, prim_a, prim_b, prim_c, E, target
    )
    cached = _cache_load(key)
    if cached is not None:
        return cached if len(cached) else None

    a64 = np.asarray(prim_a, np.float64)
    b64 = np.asarray(prim_b, np.float64)
    c64 = np.asarray(prim_c, np.float64)

    # emitter vertex set (tri: v0, v0+ab, v0+ac; quad adds the far corner)
    everts = []
    for i in E:
        everts += [a64[i], a64[i] + b64[i], a64[i] + c64[i]]
        if kind[i] == kind_quad:
            everts.append(a64[i] + b64[i] + c64[i])
    everts = np.asarray(everts)  # (V,3)

    scene_min = np.asarray(aabb_min, np.float64).min(axis=0)
    scene_max = np.asarray(aabb_max, np.float64).max(axis=0)
    scale = float(np.max(scene_max - scene_min))
    if not np.isfinite(scale) or scale <= 0:
        return _cache_store(key, None)
    tol = _REL_TOL * scale
    # the dilation must cover BOTH the f32 hit-point slop (scales with the
    # scene extent) and the kernel's f32 rounding of the baked box bounds
    # (scales with coordinate MAGNITUDE: a scene of extent 1 centered at
    # x=50 rounds its bounds by up to ~50*2^-23, not ~1*2^-23) — otherwise
    # an f32 hit just past a face bordering an unproven cell could pass the
    # in-kernel membership compare and skip a walk that would have found an
    # occluder
    mag = float(np.max(np.abs(np.stack([scene_min, scene_max]))))
    eps_out = _REL_EPS_OUT * max(scale, mag)

    # prim planes (f64). Degenerate normals -> never harmless.
    n = np.cross(b64, c64)  # (N,3); spheres give 0 (b x c with c = 0)
    nl = np.linalg.norm(n, axis=1)
    planar = (kind != kind_sphere) & (nl > 0)
    nsafe = np.where(nl[:, None] > 0, n / np.maximum(nl, 1e-300)[:, None], 0.0)
    d = -(nsafe * a64).sum(axis=1)  # plane offset per prim

    # per-prim signed-distance range of the emitter vertex set
    ldist = everts @ nsafe.T + d  # (V,N)
    lmin = ldist.min(axis=0)
    lmax = ldist.max(axis=0)
    light_coplanar = planar & (np.abs(ldist).max(axis=0) <= tol)

    # emitter box (padded) for the shaft hull
    pad = 1e-6 * scale
    emin = everts.min(axis=0) - pad
    emax = everts.max(axis=0) + pad

    # grid: EXACT scene AABB (boundary cells share faces with boundary
    # geometry — the planar test needs that alignment)
    gmin, gmax = scene_min, scene_max
    dims = _axis_dims(gmax - gmin, target)
    nx, ny, nz = dims
    cell = (gmax - gmin) / np.asarray(dims, np.float64)

    tmin_p = np.asarray(aabb_min, np.float64) - pad  # (N,3) blocker boxes
    tmax_p = np.asarray(aabb_max, np.float64) + pad

    # all cell bounds, dilated for the proof (C = cells, vectorized)
    ix, iy, iz = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    idx3 = np.stack([ix.ravel(), iy.ravel(), iz.ravel()], axis=1)  # (C,3)
    cmin_all = gmin + cell * idx3 - eps_out
    cmax_all = gmin + cell * (idx3 + 1) + eps_out
    C = len(idx3)

    sphere_mask = kind == kind_sphere
    N = len(kind)
    proven = np.zeros(C, np.bool_)

    # max cell-corner to light-corner distance per cell (cos denominators)
    lo_d = np.maximum(np.abs(emin - cmax_all), np.abs(emax - cmin_all))
    maxdist = np.linalg.norm(lo_d, axis=1)  # (C,)

    # small chunks keep the (c,N) temporaries cache-resident (numpy is
    # bandwidth-bound here)
    chunk = max(1, int(2e5) // max(N, 1))
    for s in range(0, C, chunk):
        cmin = cmin_all[s : s + chunk]  # (c,3)
        cmax = cmax_all[s : s + chunk]
        c = len(cmin)

        # hull-overlap t-intervals per axis (exact box-vs-hull test):
        # need cmin + t*(emin-cmin) <= tmax_p and tmin_p <= cmax + t*(emax-cmax)
        lo = np.zeros((c, N))
        hi = np.ones((c, N))
        ok = np.ones((c, N), np.bool_)
        for ax in range(3):
            d1 = emin[ax] - cmin[:, ax : ax + 1]  # (c,1)
            d2 = emax[ax] - cmax[:, ax : ax + 1]
            r1 = tmax_p[None, :, ax] - cmin[:, ax : ax + 1]  # (c,N)
            r2 = tmin_p[None, :, ax] - cmax[:, ax : ax + 1]
            with np.errstate(divide="ignore", invalid="ignore"):
                q1 = r1 / d1
                q2 = r2 / d2
            pos1, neg1 = d1 > 0, d1 < 0
            hi = np.where(pos1, np.minimum(hi, q1), hi)
            lo = np.where(neg1, np.maximum(lo, q1), lo)
            ok &= np.where(pos1 | neg1, True, r1 >= 0)
            pos2, neg2 = d2 > 0, d2 < 0
            lo = np.where(pos2, np.maximum(lo, q2), lo)
            hi = np.where(neg2, np.minimum(hi, q2), hi)
            ok &= np.where(pos2 | neg2, True, r2 <= 0)
        overlap = ok & (lo <= hi)  # (c,N)

        # planar harmlessness: signed-distance range of the dilated cell
        half = (cmax - cmin) * 0.5
        ctr = (cmin + cmax) * 0.5
        cd = ctr @ nsafe.T + d  # (c,N)
        rad = half @ np.abs(nsafe).T  # (c,N): sum_ax half_ax * |n_ax|
        d_lo = cd - rad
        d_hi = cd + rad
        md = maxdist[s : s + chunk, None]  # (c,1)

        # + side: cell above plane (within straddle), light above plane
        num_pos = lmin[None, :] - d_hi  # min over corner pairs of (l-o).n
        with np.errstate(divide="ignore", invalid="ignore"):
            tcross_pos = (-d_lo) * md / num_pos
        pos_ok = (lmin[None, :] >= -tol) & (
            (d_lo >= -tol) | ((num_pos > 0) & (tcross_pos <= T_BUDGET))
        )
        # - side (mirror)
        num_neg = d_lo - lmax[None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            tcross_neg = d_hi * md / num_neg
        neg_ok = (lmax[None, :] <= tol) & (
            (d_hi <= tol) | ((num_neg > 0) & (tcross_neg <= T_BUDGET))
        )
        harmless = planar[None, :] & (
            pos_ok | neg_ok | light_coplanar[None, :]
        )
        blocked = overlap & ~harmless
        blocked |= overlap & sphere_mask[None, :]
        proven[s : s + chunk] = ~blocked.any(axis=1)

    if proven.mean() < _MIN_COVER:
        return _cache_store(key, None)

    grid = proven.reshape(nx, ny, nz)
    boxes = _greedy_boxes(grid)
    if not boxes:
        return _cache_store(key, None)
    out = [len(boxes)]
    for (x0, y0, z0, x1, y1, z1) in boxes:
        b0 = gmin + cell * np.array([x0, y0, z0], np.float64)
        b1 = gmin + cell * np.array([x1, y1, z1], np.float64)
        # boundary faces extend by eps_out (covered by the dilated proofs;
        # catches f32 hit points rounded just outside the scene AABB)
        for ax, (i0, i1, nax) in enumerate(
            ((x0, x1, nx), (y0, y1, ny), (z0, z1, nz))
        ):
            if i0 == 0:
                b0[ax] -= eps_out
            if i1 == nax:
                b1[ax] += eps_out
        out += [float(v) for v in np.concatenate([b0, b1])]
    return _cache_store(key, tuple(out))


def _grow_box(grid, seed):
    """Grow an all-True box greedily around a True seed cell."""
    nx, ny, nz = grid.shape
    x0, y0, z0 = seed
    x1, y1, z1 = x0 + 1, y0 + 1, z0 + 1
    grew = True
    while grew:
        grew = False
        for lo_hi, ax, n in (
            (0, 0, nx), (1, 0, nx), (0, 1, ny),
            (1, 1, ny), (0, 2, nz), (1, 2, nz),
        ):
            b = [x0, x1, y0, y1, z0, z1]
            i = 2 * ax + lo_hi
            if lo_hi == 0 and b[i] > 0:
                b[i] -= 1
            elif lo_hi == 1 and b[i] < n:
                b[i] += 1
            else:
                continue
            if grid[b[0] : b[1], b[2] : b[3], b[4] : b[5]].all():
                x0, x1, y0, y1, z0, z1 = b
                grew = True
    return (x0, y0, z0, x1, y1, z1)


def _greedy_boxes(grid: np.ndarray, max_boxes: int = MAX_BOXES,
                  seeds_per_round: int = 24):
    """Greedy cover of True cells with axis-aligned all-True boxes: each
    round grows boxes from several uncovered seeds and keeps the one that
    covers the most still-uncovered cells (overlap between boxes is fine —
    the kernel ORs them). Returns [(x0,y0,z0,x1,y1,z1)] in cell coords,
    half-open."""
    covered = np.zeros_like(grid)
    boxes = []
    rng = np.random.default_rng(0)
    for _ in range(max_boxes):
        gain = grid & ~covered
        ncand = int(gain.sum())
        if ncand == 0:
            break
        flat = np.flatnonzero(gain.ravel())
        picks = flat[rng.choice(ncand, min(seeds_per_round, ncand),
                                replace=False)]
        best, best_gain = None, 0
        for f in picks:
            seed = np.unravel_index(f, grid.shape)
            b = _grow_box(grid, seed)
            g = int(gain[b[0]:b[3], b[1]:b[4], b[2]:b[5]].sum())
            if g > best_gain:
                best, best_gain = b, g
        x0, y0, z0, x1, y1, z1 = best
        covered[x0:x1, y0:y1, z0:z1] = True
        boxes.append(best)
    return boxes
