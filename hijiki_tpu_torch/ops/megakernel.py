"""The path-tracing megakernel on Hopper, its plain twin, and the phased driver.

Port of ``hijiki_tpu/ops/pallas_megakernel.py``: ``render_waves`` traces
every path of a sweep with a camera launch (``mk_start``, the counterpart of
``_megakernel_start``) up to ``phase_bounces[0]``, then compacts and sorts
the survivors with plain torch ops and resumes them (``mk_resume``, the
counterpart of ``_megakernel_resume``) at the later caps.

On a CUDA tensor the two launches run the hand-written kernels of
``csrc/megakernel.cu`` (one thread per path, the stackless walk over the
trace rows; see the note there). On a CPU tensor they run the plain twin
below: a vectorized per-lane transcription of ``_camera_init``,
``_bounce_loop``, ``_analytic_pretest``, the walk and ``_resolve_winners``
that computes, lane by lane, what one CUDA thread computes. Differences to
the TPU kernel, all per-lane semantics of the same estimator:

* each lane walks its own cursor (the TPU walks packets that descend when
  any lane's slab test passes) and picks the octant table by its own
  direction signs (the TPU votes per packet): the same closest hit up to
  the t-tie class;
* the ``rows`` counter counts the rows this lane visited (closest walk,
  winner fetch, shadow walk), not packet unions, and a dead lane's
  ``bounce`` stops where it died (the TPU tile loop keeps counting);
* ``lax.rsqrt`` is ``1 / sqrt`` here and in the kernel.

State layout: ``(N_STATE, N)`` f32, lane-major, channels ``_STATE_CH``, plus
the RNG as an ``(N,)`` int32 tensor of the u32 bits, which the kernels read
as ``uint32_t``. The twin computes in int64-held u32 values (``ops/rng.py``:
CPU torch has no uint32 shifts) and converts at its own boundary.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from hijiki_tpu_torch.ops.rng import from_bits, to_bits, wang_hash, xorshift
from hijiki_tpu_torch.scene.compile import CompiledScene

M_EPS = 1e-4
M_PI = 3.1415926535897932384626433832795
BIG = 3.0e38  # f32-finite stand-in for the reference's 1e100 -> inf tmax
# capacity granule of the compaction phases: the TPU kernel's tile of
# 8 x 128 lanes, kept so phase capacities and overflow counts match it
TILE = 1024

KIND_SPHERE = 0.0
KIND_QUAD = 1.0
KIND_TRIANGLE = 2.0
TAG_DIFFUSE = 0.0
TAG_DIFFUSECBOARD = 1.0
TAG_MIRROR = 2.0
TAG_DIELECTRIC = 3.0
TAG_EMISSIVE = 4.0

# f32 state-pack channel order (ints stored as exact small floats)
_STATE_CH = [
    "alive", "bounce", "ox", "oy", "oz", "dx", "dy", "dz", "tmin",
    "tr", "tg", "tb", "er", "eg", "eb", "Lr", "Lg", "Lb", "wd",
    "depth", "n1", "n2", "n3", "rows", "ar", "ag", "ab", "segs",
    "samp",
]
N_STATE = len(_STATE_CH)
# result-channel order of the (12, N) result buffer
_RESULT_CH = tuple(
    _STATE_CH.index(ch)
    for ch in (
        "Lr", "Lg", "Lb", "n1", "n2", "n3",
        "depth", "segs", "rows", "ar", "ag", "ab",
    )
)

# launches of each hand-written kernel (CUDA tensors only; the CPU twin is
# not counted). Read and reset by chip_smoke.py to prove the main path ran
# through the kernels.
LAUNCHES = {"mk_start": 0, "mk_resume": 0}

_f32 = np.float32
# layout of one baked analytic prim / emitter in the constants buffer
ANALYTIC_STRIDE = 16
EMITTER_STRIDE = 28


def _f(x) -> float:
    """Round a python float to the nearest f32 (as ``f32(x)`` in a kernel)."""
    return float(_f32(x))


@dataclass
class MegaScene:
    """Everything the megakernel reads, for one scene at one image size.

    ``rows`` is the trace table on ``device``; ``consts`` packs the baked
    analytic prims, emitters and material tables as f32 (the TPU kernel
    baked them as compile-time immediates). Each derived constant is
    computed here in double precision and rounded to f32 exactly where the
    TPU kernel's python-float arithmetic did.
    """

    rows: torch.Tensor  # (total_rows, 32) f32
    consts: torch.Tensor  # flat f32, layout below
    total_rows: int
    tbl_rows: int
    ntab: int
    analytic_mode: bool
    analytic: np.ndarray  # (NA, 16) f32
    emitters: np.ndarray  # (E, 28) f32
    diffuse: np.ndarray  # (nd, 3) f32
    cboard: np.ndarray  # (ncb, 8) f32
    diel: np.ndarray  # (ndl, 4) f32
    emissive: np.ndarray  # (nem, 3) f32
    cam: np.ndarray  # (15,) f32: c.xyz, R (row-major 3x3), halfW, halfH, scale
    root_min: torch.Tensor  # (3,) f32 BVH root box (compaction sort key)
    root_max: torch.Tensor

    @property
    def n_analytic(self) -> int:
        return self.analytic.shape[0]


def _analytic_rows(bake) -> np.ndarray:
    """(kind, tag, midx, a, b, c, d0..d3): d0 = f32(r*r) for spheres, d0..2 =
    f32(edge1 x edge2) for quads — the double-precision bakes of
    ``_analytic_pretest``."""
    out = np.zeros((len(bake), ANALYTIC_STRIDE), np.float32)
    for k, e in enumerate(bake):
        out[k, :12] = e[:12]
        g = e[3:12]
        if e[0] == KIND_SPHERE:
            out[k, 12] = _f(g[3] * g[3])
        else:
            v1, v2 = g[3:6], g[6:9]
            out[k, 12] = _f(v1[1] * v2[2] - v1[2] * v2[1])
            out[k, 13] = _f(v1[2] * v2[0] - v1[0] * v2[2])
            out[k, 14] = _f(v1[0] * v2[1] - v1[1] * v2[0])
    return out


def _emitter_rows(bake) -> np.ndarray:
    """(kind, em_pdf, cdf, power3, geometry18, area_pdf, quad normal3)."""
    out = np.zeros((len(bake), EMITTER_STRIDE), np.float32)
    for e, b in enumerate(bake):
        out[e, :24] = b[:24]
        g = b[6:]
        if b[0] == 2:  # triangle (shapes/triangle.glsl:81-102)
            pa, pb, pc = g[0:3], g[3:6], g[6:9]
            ab = [pb[i] - pa[i] for i in range(3)]
            ac = [pc[i] - pa[i] for i in range(3)]
            cr = (
                ab[1] * ac[2] - ab[2] * ac[1],
                ab[2] * ac[0] - ab[0] * ac[2],
                ab[0] * ac[1] - ab[1] * ac[0],
            )
            area = 0.5 * math.sqrt(cr[0] ** 2 + cr[1] ** 2 + cr[2] ** 2)
            out[e, 24] = _f(1.0 / area)
        elif b[0] == 1:  # quad (shapes/quad.glsl:34-45)
            e1, e2 = g[3:6], g[6:9]
            cr = (
                e1[1] * e2[2] - e1[2] * e2[1],
                e1[2] * e2[0] - e1[0] * e2[2],
                e1[0] * e2[1] - e1[1] * e2[0],
            )
            area = math.sqrt(cr[0] * cr[0] + cr[1] * cr[1] + cr[2] * cr[2])
            out[e, 24] = _f(1.0 / area)
            out[e, 25:28] = [_f(c / area) for c in cr]
        else:  # sphere (shapes/sphere.glsl:54-62)
            rr = g[3]
            out[e, 24] = _f(1.0 / (rr * rr * 4.0 * M_PI))
    return out


def _camera_consts(camera_static, width, height) -> np.ndarray:
    """``_camera_ray``'s bake: the quaternion as a rotation matrix and the
    pixel scale, in double, each rounded to f32."""
    cx, cy, cz, qx, qy, qz, qw, fov = camera_static
    R = (
        1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw),
        2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw),
        2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy),
    )
    scale = math.tan(math.radians(0.5 * fov)) / (0.5 * width)
    return np.asarray(
        (cx, cy, cz) + R + (0.5 * width, 0.5 * height, scale), np.float32
    )


def _table(rows, ncols) -> np.ndarray:
    return np.asarray(rows, np.float32).reshape(-1, ncols)


def mega_scene(cs: CompiledScene, width: int, height: int, device) -> MegaScene:
    """Bake ``cs`` (numpy or tensor fields) for the megakernel on ``device``."""
    if cs.mega_packed_static:
        raise NotImplementedError("packed trace-row formats are not ported yet")
    diffuse, cb, diel, emis = cs.material_bake_static
    analytic = _analytic_rows(
        cs.analytic_bake_static if cs.mega_analytic_mode_static else ()
    )
    emitters = _emitter_rows(cs.emitter_bake_static)
    tabs = dict(
        diffuse=_table(diffuse, 3), cboard=_table(cb, 8),
        diel=_table(diel, 4), emissive=_table(emis, 3),
    )
    cam = _camera_consts(cs.camera_static, width, height)
    consts = np.concatenate(
        [cam, analytic.ravel(), emitters.ravel()]
        + [tabs[k].ravel() for k in ("diffuse", "cboard", "diel", "emissive")]
        + [np.zeros(1, np.float32)]
    ).astype(np.float32)
    rows = torch.as_tensor(np.asarray(_cpu(cs.trace_rows_mega), np.float32))
    bmin = np.asarray(_cpu(cs.bvh_aabb_min), np.float32)[0]
    bmax = np.asarray(_cpu(cs.bvh_aabb_max), np.float32)[0]
    return MegaScene(
        rows=rows.to(device).contiguous(),
        consts=torch.from_numpy(consts).to(device),
        total_rows=rows.shape[0],
        tbl_rows=rows.shape[0] // cs.mega_num_tables_static,
        ntab=cs.mega_num_tables_static,
        analytic_mode=bool(cs.mega_analytic_mode_static),
        analytic=analytic,
        emitters=emitters,
        cam=cam,
        root_min=torch.from_numpy(bmin).to(device),
        root_max=torch.from_numpy(bmax).to(device),
        **tabs,
    )


def _cpu(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else a


# ----------------------------------------------------------------------------
# the plain twin: RNG and math helpers
# ----------------------------------------------------------------------------
# Every operation below is one f32 operation in the same order as the TPU
# kernel and as csrc/megakernel.cu. Division by a python number is avoided
# on purpose (torch's CUDA division by a CPU scalar multiplies by its
# reciprocal, which rounds differently).


def _u32_to_f32(s):
    """float(u32) as ``_u32_to_f32`` computes it in the TPU kernel: the bits
    as int32, converted, then +2^32 when negative (not the direct u32 cast,
    which may round 1 ULP differently for values >= 2^31)."""
    i = torch.where(s >= 2**31, s - 2**32, s)
    fv = i.to(torch.float32)
    return torch.where(i < 0, fv + 4294967296.0, fv)


def _randf(s):
    s = xorshift(s)
    return s, _u32_to_f32(s) * (1.0 / 4294967296.0)


def _atan_poly(z):
    """atan(z) for |z| <= 1, minimax odd polynomial (~1e-5 abs error)."""
    t = z * z
    p = _f(0.0208351) * t - _f(0.0851330)
    p = p * t + _f(0.1801410)
    p = p * t - _f(0.3302995)
    p = p * t + _f(0.9998660)
    return z * p


def _atan2(y, x):
    """The TPU kernel's polynomial atan2 (feeds only the sphere UV); (0, 0)
    yields NaN like GLSL's undefined atan(0, 0)."""
    ax, ay = torch.abs(x), torch.abs(y)
    swap = ay > ax
    num = torch.where(swap, ax, ay)
    den = torch.where(swap, ay, ax)
    r = _atan_poly(num / den)
    r = torch.where(swap, _f(0.5 * M_PI) - r, r)
    r = torch.where(x < 0, _f(M_PI) - r, r)
    return torch.where(y < 0, -r, r)


def _asin(x):
    return _atan2(x, torch.sqrt(torch.clamp_min(1.0 - x * x, 0.0)))


def _rsqrt(x):
    """``lax.rsqrt`` as 1 / sqrt (IEEE division and square root, as in the
    CUDA kernel, which avoids the approximate ``rsqrtf``)."""
    return 1.0 / torch.sqrt(x)


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _select_row(midx, table, ncols, default=0.0):
    """``_bake_select``: row ``midx`` of a small baked table, ``default``
    where midx is past its end."""
    outs = [torch.full_like(midx, default) for _ in range(ncols)]
    for k in range(table.shape[0]):
        sel = midx == float(k)
        for j in range(ncols):
            outs[j] = torch.where(sel, float(table[k, j]), outs[j])
    return outs


def _octant_base(ms, dx, dy, dz):
    """Table base of each lane: the octant table of its own direction signs
    (the TPU kernel votes one per packet)."""
    if ms.ntab == 1:
        return torch.zeros(dx.shape, dtype=torch.int64, device=dx.device)
    oct_ = (dx > 0).long() + 2 * (dy > 0).long() + 4 * (dz > 0).long()
    return oct_ * ms.tbl_rows


# ----------------------------------------------------------------------------
# the plain twin: walks
# ----------------------------------------------------------------------------


def _analytic_test(a, o, d, tmin, best_t):
    """One baked analytic prim against all lanes -> (phit, pt, pu, pv)."""
    ox, oy, oz = o
    dx, dy, dz = d
    if a[0] == KIND_SPHERE:
        rx, ry, rz = ox - float(a[3]), oy - float(a[4]), oz - float(a[5])
        sb = 2.0 * _dot(dx, dy, dz, rx, ry, rz)
        sc = _dot(rx, ry, rz, rx, ry, rz) - float(a[12])
        disc = sb * sb - 4.0 * sc
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        st0 = -0.5 * (sb + sq)
        st1 = -0.5 * (sb - sq)
        ok0 = (tmin <= st0) & (st0 <= best_t)
        ok1 = (tmin <= st1) & (st1 <= best_t)
        pt = torch.where(ok0, st0, st1)
        phit = (disc >= 0.0) & (ok0 | ok1)
        zero = torch.zeros_like(pt)
        return phit, pt, zero, zero
    n0, n1, n2 = float(a[12]), float(a[13]), float(a[14])
    rx, ry, rz = ox - float(a[3]), oy - float(a[4]), oz - float(a[5])
    qx = ry * dz - rz * dy
    qy = rz * dx - rx * dz
    qz = rx * dy - ry * dx
    dd = 1.0 / (dx * n0 + dy * n1 + dz * n2)
    pu = -dd * (qx * float(a[9]) + qy * float(a[10]) + qz * float(a[11]))
    pv = dd * (qx * float(a[6]) + qy * float(a[7]) + qz * float(a[8]))
    pt = -dd * (n0 * rx + n1 * ry + n2 * rz)
    phit = (pu >= 0) & (pu <= 1.0) & (pv >= 0) & (pv <= 1.0)
    phit = phit & (tmin <= pt) & (pt <= best_t)
    return phit, pt, pu, pv


def _prim_test(ms, r, o, d, tmin, best_t):
    """Test the prim rows ``r`` (n, 32) against their lanes (``_prim_test``
    with classic rows; analytic tables hold triangles only)."""
    ox, oy, oz = o
    dx, dy, dz = d
    col = lambda j: r[:, j]
    v0x, v0y, v0z = col(0), col(1), col(2)
    v1x, v1y, v1z = col(3), col(4), col(5)
    v2x, v2y, v2z = col(6), col(7), col(8)
    nx, ny, nz = col(29), col(30), col(31)
    rx, ry, rz = ox - v0x, oy - v0y, oz - v0z
    qx = ry * dz - rz * dy
    qy = rz * dx - rx * dz
    qz = rx * dy - ry * dx
    dd = 1.0 / (dx * nx + dy * ny + dz * nz)
    u = -dd * (qx * v2x + qy * v2y + qz * v2z)
    v = dd * (qx * v1x + qy * v1y + qz * v1z)
    t_pq = -dd * (nx * rx + ny * ry + nz * rz)
    in_tri = (u >= 0) & (v >= 0) & (u + v <= 1.0)
    if ms.analytic_mode:
        return in_tri & (tmin <= t_pq), t_pq, u, v
    kind = col(9)
    is_tri = kind == KIND_TRIANGLE
    in_quad = (u >= 0) & (u <= 1.0) & (v >= 0) & (v <= 1.0)
    ok_pq = (is_tri & in_tri) | (~is_tri & in_quad)
    ok_pq = ok_pq & (tmin <= t_pq) & (t_pq <= best_t)
    radius = v1x
    sb = 2.0 * _dot(dx, dy, dz, rx, ry, rz)
    sc = _dot(rx, ry, rz, rx, ry, rz) - radius * radius
    disc = sb * sb - 4.0 * sc
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    st0 = -0.5 * (sb + sq)
    st1 = -0.5 * (sb - sq)
    ok0 = (tmin <= st0) & (st0 <= best_t)
    ok1 = (tmin <= st1) & (st1 <= best_t)
    t_s = torch.where(ok0, st0, st1)
    ok_s = (disc >= 0.0) & (ok0 | ok1)
    is_sphere = kind == KIND_SPHERE
    phit = torch.where(is_sphere, ok_s, ok_pq)
    pt = torch.where(is_sphere, t_s, t_pq)
    pu = torch.where(is_sphere, 0.0, u)
    pv = torch.where(is_sphere, 0.0, v)
    return phit, pt, pu, pv


def _walk(ms, o, d, tmin, tmax, any_hit, best):
    """Per-lane stackless walk of the trace rows from each lane's octant
    table: row ``cur``, then ``cur + 1`` (interior row whose box the ray
    enters) or the exit pointer in column 10. ``best`` holds the analytic
    pretest's result and is updated in place. Returns the rows visited."""
    ox, oy, oz = o
    dx, dy, dz = d
    inv_x, inv_y, inv_z = 1.0 / dx, 1.0 / dy, 1.0 / dz
    tox, toy, toz = -ox * inv_x, -oy * inv_y, -oz * inv_z
    base = _octant_base(ms, dx, dy, dz)
    end = base + ms.tbl_rows
    # lanes that can accept nothing (tmax < 0) or already hit do not walk
    done = ~(tmax >= 0.0)
    if any_hit:
        done = done | best["hit"]
    cur = torch.where(done, end, base)
    nit = torch.zeros(dx.shape, dtype=torch.float32, device=dx.device)
    rows = ms.rows
    while True:
        act = cur < end
        if not bool(act.any()):
            break
        r = rows[torch.clamp_max(cur, ms.total_rows - 1)]
        is_prim = r[:, 9] >= 0.0
        nexit = r[:, 10].long()
        best_t = tmax if any_hit else best["t"]
        ax = r[:, 0] * inv_x + tox
        bx = r[:, 3] * inv_x + tox
        ay = r[:, 1] * inv_y + toy
        by = r[:, 4] * inv_y + toy
        az = r[:, 2] * inv_z + toz
        bz = r[:, 5] * inv_z + toz
        t0 = torch.maximum(
            torch.maximum(torch.minimum(ax, bx), torch.minimum(ay, by)),
            torch.minimum(az, bz),
        )
        t1 = torch.minimum(
            torch.minimum(torch.maximum(ax, bx), torch.maximum(ay, by)),
            torch.maximum(az, bz),
        )
        slab = (t0 < t1 + _f(M_EPS)) & (t0 < best_t) & (t1 > tmin)
        phit, pt, pu, pv = _prim_test(ms, r, o, d, tmin, best_t)
        accept = act & is_prim & phit & (pt < best_t)
        nxt = torch.where(~is_prim & slab, cur + 1, nexit)
        if any_hit:
            best["hit"] = best["hit"] | accept
            nxt = torch.where(accept, end, nxt)
        else:
            best["t"] = torch.where(accept, pt, best["t"])
            best["u"] = torch.where(accept, pu, best["u"])
            best["v"] = torch.where(accept, pv, best["v"])
            best["wrow"] = torch.where(accept, cur, best["wrow"])
        cur = torch.where(act, nxt, cur)
        nit = nit + act.to(torch.float32)
    return nit


def _trace_closest(ms, o, d, tmin, tmax):
    """Closest hit: analytic pretest, walk, winner resolve. Returns a dict
    with t, u, v, hitf, kind, tag, midx, pay (15 tensors) and nit."""
    enc = ms.total_rows
    NA = ms.n_analytic
    best = dict(
        t=tmax.clone(),
        u=torch.zeros_like(tmax),
        v=torch.zeros_like(tmax),
        wrow=torch.full(tmax.shape, enc + NA, dtype=torch.int64, device=tmax.device),
    )
    for k in range(NA):
        phit, pt, pu, pv = _analytic_test(ms.analytic[k], o, d, tmin, best["t"])
        acc = phit & (pt < best["t"])
        best["t"] = torch.where(acc, pt, best["t"])
        best["u"] = torch.where(acc, pu, best["u"])
        best["v"] = torch.where(acc, pv, best["v"])
        best["wrow"] = torch.where(acc, enc + k, best["wrow"])
    nit = _walk(ms, o, d, tmin, tmax, False, best)
    wrow = best["wrow"]
    tab = wrow < enc
    r = ms.rows[torch.clamp_max(wrow, enc - 1)]
    zero = torch.zeros_like(tmax)
    kind = torch.where(tab, r[:, 9], zero)
    is_tri = kind == KIND_TRIANGLE
    out = dict(
        t=best["t"], u=best["u"], v=best["v"],
        hitf=wrow < enc + NA,
        kind=kind,
        tag=torch.where(tab, r[:, 12], zero),
        midx=torch.where(tab, r[:, 13], zero),
        nit=nit + tab.to(torch.float32),
    )
    pay = []
    for j in range(15):
        geo = r[:, j] if j < 9 else zero
        pay.append(torch.where(tab, torch.where(is_tri, r[:, 14 + j], geo), zero))
    for k in range(NA):
        a = ms.analytic[k]
        sel = wrow == enc + k
        for name, c in (("kind", 0), ("tag", 1), ("midx", 2)):
            out[name] = torch.where(sel, float(a[c]), out[name])
        for j in range(9):
            pay[j] = torch.where(sel, float(a[3 + j]), pay[j])
    out["pay"] = pay
    return out


def _trace_any(ms, o, d, tmin, tmax):
    """Any hit in (tmin, tmax): returns (hit bool, rows visited)."""
    best = dict(hit=torch.zeros(tmax.shape, dtype=torch.bool, device=tmax.device))
    for k in range(ms.n_analytic):
        bt = torch.where(best["hit"], tmin, tmax)
        phit, pt, _, _ = _analytic_test(ms.analytic[k], o, d, tmin, bt)
        best["hit"] = best["hit"] | (phit & (pt < bt))
    nit = _walk(ms, o, d, tmin, tmax, True, best)
    return best["hit"], nit


# ----------------------------------------------------------------------------
# the plain twin: camera, one bounce, the bounce loop
# ----------------------------------------------------------------------------


def _camera_ray(ms, px, py):
    """``_camera_ray``: jittered pinhole direction from the baked matrix."""
    c = [float(x) for x in ms.cam]
    R = c[3:12]
    half_w, half_h, scale = c[12], c[13], c[14]
    lx = (px - half_w) * scale
    ly = -(py - half_h) * scale
    dxu = R[0] * lx + R[1] * ly - R[2]
    dyu = R[3] * lx + R[4] * ly - R[5]
    dzu = R[6] * lx + R[7] * ly - R[8]
    inv_len = _rsqrt(dxu * dxu + dyu * dyu + dzu * dzu)
    return dxu * inv_len, dyu * inv_len, dzu * inv_len


def _camera_init(ms, px, py, seeds):
    """Initial path state (``_camera_init``): dict of per-lane tensors."""
    ndx, ndy, ndz = _camera_ray(ms, px, py)
    zero = torch.zeros_like(px)
    one = torch.ones_like(px)
    s = {ch: zero for ch in _STATE_CH}
    s.update(
        alive=one, bounce=zero, segs=px * 0.0, samp=px * 0.0,
        ox=torch.full_like(px, float(ms.cam[0])),
        oy=torch.full_like(px, float(ms.cam[1])),
        oz=torch.full_like(px, float(ms.cam[2])),
        dx=ndx, dy=ndy, dz=ndz,
        tmin=torch.full_like(px, _f(M_EPS)),
        tr=one, tg=one, tb=one, wd=one,
    )
    s["state"] = wang_hash(seeds)
    return s


def _checkerboard(c1r, c1g, c1b, su, c2r, c2g, c2b, sv, uvx, uvy):
    """materials/diffusecb.glsl:6-13."""
    stx = 0.5 * uvx / su
    sty = 0.5 * uvy / sv
    stx = stx - torch.floor(stx)
    sty = sty - torch.floor(sty)
    flip = (stx < 0.5) ^ (sty < 0.5)
    return (
        torch.where(flip, c2r, c1r),
        torch.where(flip, c2g, c1g),
        torch.where(flip, c2b, c1b),
    )


def _sample_emitters(ms, u_pick, eu1, eu2):
    """Threshold emitter pick (scene.glsl:57-64: first e with u < cdf_e,
    fallback emitter 0) and the picked emitter's point sample."""
    W = torch.where
    sel_out = None
    for e in range(ms.emitters.shape[0]):
        b = [float(x) for x in ms.emitters[e]]
        g = b[6:24]
        if b[0] == 2:  # triangle
            pa, pb, pc = g[0:3], g[3:6], g[6:9]
            na, nb, nc = g[9:12], g[12:15], g[15:18]
            lu = W(eu1 + eu2 > 1.0, 1.0 - eu2, eu1)
            lv = eu2
            lw = 1.0 - lu - lv
            cp = [pa[i] * lu + pb[i] * lv + pc[i] * lw for i in range(3)]
            cn = [na[i] * lu + nb[i] * lv + nc[i] * lw for i in range(3)]
            inv = _rsqrt(torch.clamp_min(_dot(*cn, *cn), _f(1e-30)))
            cn = [x * inv for x in cn]
        elif b[0] == 1:  # quad
            qo, e1, e2 = g[0:3], g[3:6], g[6:9]
            cn = [torch.full_like(u_pick, b[25 + i]) for i in range(3)]
            cp = [qo[i] + eu1 * e1[i] + eu2 * e2[i] for i in range(3)]
        else:  # sphere
            z = 2.0 * eu1 - 1.0
            theta = _f(2.0 * M_PI) * eu2
            rxy = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
            cn = [rxy * torch.cos(theta), rxy * torch.sin(theta), z]
            cp = [g[i] + g[3] * cn[i] for i in range(3)]
        vals = cp + cn + [torch.full_like(u_pick, b[24])] + [
            torch.full_like(u_pick, b[i]) for i in (3, 4, 5, 1)
        ]
        if sel_out is None:
            sel_out = vals
        else:
            sel = (u_pick >= float(ms.emitters[e - 1, 2])) & (u_pick < b[2])
            sel_out = [W(sel, v, s) for v, s in zip(vals, sel_out)]
    return sel_out  # px,py,pz, nx,ny,nz, area_pdf, pwr,pwg,pwb, em_pdf


def _bounce(ms, s):
    """One bounce of every lane in ``s`` (all alive and under their cap):
    the body of ``_bounce_loop``. Returns the new state dict."""
    W = torch.where
    f32 = torch.float32
    ox, oy, oz = s["ox"], s["oy"], s["oz"]
    dx, dy, dz = s["dx"], s["dy"], s["dz"]
    h = _trace_closest(ms, (ox, oy, oz), (dx, dy, dz), s["tmin"],
                       torch.full_like(ox, BIG))
    found = h["hitf"]
    t, kind, tag, midx = h["t"], h["kind"], h["tag"], h["midx"]
    u, v, pay = h["u"], h["v"], h["pay"]
    hx, hy, hz = ox + t * dx, oy + t * dy, oz + t * dz

    # ---- shading frame (scalarized populate_intersection) ----
    is_s = kind == KIND_SPHERE
    is_q = kind == KIND_QUAD
    sr_inv = 1.0 / W(is_s, pay[3], 1.0)
    snx, sny, snz = (hx - pay[0]) * sr_inv, (hy - pay[1]) * sr_inv, (hz - pay[2]) * sr_inv
    st_len = _rsqrt(torch.clamp_min(snz * snz + snx * snx, _f(1e-30)))
    stx, stz = -snz * st_len, snx * st_len
    sbx, sby, sbz = sny * stz, snz * stx - snx * stz, -sny * stx
    s_uvx = 0.5 + _atan2(snz, snx) * _f(1.0 / (2.0 * M_PI))
    s_uvx = W(torch.isnan(s_uvx), 0.0, s_uvx)
    s_uvy = 0.5 + _asin(torch.clamp(sny, -1.0, 1.0)) * _f(1.0 / M_PI)

    q1l = _rsqrt(torch.clamp_min(_dot(pay[3], pay[4], pay[5], pay[3], pay[4], pay[5]), _f(1e-30)))
    qtx, qty, qtz = pay[3] * q1l, pay[4] * q1l, pay[5] * q1l
    q2l = _rsqrt(torch.clamp_min(_dot(pay[6], pay[7], pay[8], pay[6], pay[7], pay[8]), _f(1e-30)))
    qbx, qby, qbz = pay[6] * q2l, pay[7] * q2l, pay[8] * q2l
    qnx, qny, qnz = qty * qbz - qtz * qby, qtz * qbx - qtx * qbz, qtx * qby - qty * qbx

    lam0 = 1.0 - u - v
    tnx = pay[0] * lam0 + pay[3] * u + pay[6] * v
    tny = pay[1] * lam0 + pay[4] * u + pay[7] * v
    tnz = pay[2] * lam0 + pay[5] * u + pay[8] * v
    tn_inv = _rsqrt(torch.clamp_min(_dot(tnx, tny, tnz, tnx, tny, tnz), _f(1e-30)))
    tnx, tny, tnz = tnx * tn_inv, tny * tn_inv, tnz * tn_inv
    t_uvx = pay[9] * lam0 + pay[11] * u + pay[13] * v
    t_uvy = pay[10] * lam0 + pay[12] * u + pay[14] * v
    use_y = torch.abs(tnx) > torch.abs(tny)
    ttx = W(use_y, -tnz, 0.0)
    tty = W(use_y, 0.0, tnz)
    ttz = W(use_y, tnx, -tny)
    tt_inv = _rsqrt(torch.clamp_min(_dot(ttx, tty, ttz, ttx, tty, ttz), _f(1e-30)))
    ttx, tty, ttz = ttx * tt_inv, tty * tt_inv, ttz * tt_inv
    tbx, tby, tbz = tny * ttz - tnz * tty, tnz * ttx - tnx * ttz, tnx * tty - tny * ttx

    sel3 = lambda a_s, a_q, a_t: W(is_s, a_s, W(is_q, a_q, a_t))
    nx, ny, nz = sel3(snx, qnx, tnx), sel3(sny, qny, tny), sel3(snz, qnz, tnz)
    fx, fy, fz = sel3(stx, qtx, ttx), sel3(torch.zeros_like(stx), qty, tty), sel3(stz, qtz, ttz)
    bx_, by_, bz_ = sel3(sbx, qbx, tbx), sel3(sby, qby, tby), sel3(sbz, qbz, tbz)
    uvx, uvy = sel3(s_uvx, u, t_uvx), sel3(s_uvy, v, t_uvy)

    first = (s["bounce"] == 0) & found
    out = dict(s)
    out["depth"] = W(first, t, s["depth"])
    out["n1"], out["n2"], out["n3"] = (W(first, c, s[k]) for c, k in ((nx, "n1"), (ny, "n2"), (nz, "n3")))

    # Beer-Lambert (render.glsl:111-112)
    ddx, ddy, ddz = hx - ox, hy - oy, hz - oz
    dist = torch.sqrt(_dot(ddx, ddy, ddz, ddx, ddy, ddz))
    tr = W(found, s["tr"] * torch.exp(-s["er"] * dist), s["tr"])
    tg = W(found, s["tg"] * torch.exp(-s["eg"] * dist), s["tg"])
    tb = W(found, s["tb"] * torch.exp(-s["eb"] * dist), s["tb"])

    # emissive accumulation (render.glsl:114-116)
    pw = _select_row(midx, ms.emissive, 3)
    em = found & (tag == TAG_EMISSIVE) & (s["wd"] > 0)
    Lr = W(em, s["Lr"] + tr * pw[0], s["Lr"])
    Lg = W(em, s["Lg"] + tg * pw[1], s["Lg"])
    Lb = W(em, s["Lb"] + tb * pw[2], s["Lb"])

    # ---- NEE (render.glsl:117-126, scene.glsl:54-89) ----
    dif = found & ((tag == TAG_DIFFUSE) | (tag == TAG_DIFFUSECBOARD))
    st = s["state"]
    st1, u_pick = _randf(st)
    st2, eu1 = _randf(st1)
    st3, eu2 = _randf(st2)
    new_state = W(dif, st3, st)
    epx, epy, epz, enx, eny, enz, epdf, epwr, epwg, epwb, em_pdf = _sample_emitters(
        ms, u_pick, eu1, eu2
    )
    svx, svy, svz = epx - hx, epy - hy, epz - hz
    sdist = torch.sqrt(_dot(svx, svy, svz, svx, svy, svz))
    sd_inv = 1.0 / sdist
    sdx, sdy, sdz = svx * sd_inv, svy * sd_inv, svz * sd_inv
    cos_theta = -_dot(sdx, sdy, sdz, enx, eny, enz)
    pdf = em_pdf * epdf * sdist * sdist / cos_theta
    inv_pdf = W(cos_theta < 0.0, 0.0, 1.0 / pdf)
    impr, impg, impb = epwr * inv_pdf, epwg * inv_pdf, epwb * inv_pdf
    imp_len = torch.sqrt(_dot(impr, impg, impb, impr, impg, impb))
    gate = dif & (imp_len > _f(M_EPS)) & (_dot(sdx, sdy, sdz, nx, ny, nz) > 0)
    occluded, nit_s = _trace_any(
        ms, (hx, hy, hz), (sdx, sdy, sdz),
        torch.full_like(sdist, _f(2.0 * M_EPS)),
        W(gate, sdist - _f(M_EPS), -1.0),
    )

    # eval BSDF for NEE (material.glsl:18-30)
    dcol = _select_row(midx, ms.diffuse, 3)
    if ms.cboard.shape[0]:
        cbr, cbg, cbb = _checkerboard(*_select_row(midx, ms.cboard, 8), uvx, uvy)
    else:
        cbr = cbg = cbb = torch.zeros_like(midx)
    cosw = _dot(sdx, sdy, sdz, nx, ny, nz)
    is_dif = tag == TAG_DIFFUSE
    is_cb = tag == TAG_DIFFUSECBOARD
    fa = found & (s["bounce"] == 0)
    for ch, dc, cc in (("ar", dcol[0], cbr), ("ag", dcol[1], cbg), ("ab", dcol[2], cbb)):
        out[ch] = W(fa, W(is_dif, dc, W(is_cb, cc, 0.0)), s[ch])
    add = gate & ~occluded
    inv_pi = _f(1.0 / M_PI)
    Lr = W(add, Lr + tr * (cosw * W(is_dif, dcol[0], cbr) * inv_pi) * impr, Lr)
    Lg = W(add, Lg + tg * (cosw * W(is_dif, dcol[1], cbg) * inv_pi) * impg, Lg)
    Lb = W(add, Lb + tb * (cosw * W(is_dif, dcol[2], cbb) * inv_pi) * impb, Lb)

    # ---- BSDF sampling (material.glsl:33-91) ----
    stA, bu1 = _randf(new_state)
    stB, bu2 = _randf(stA)
    rad = torch.sqrt(bu1)
    th = _f(2.0 * M_PI) * bu2
    hlx, hly = rad * torch.cos(th), rad * torch.sin(th)
    hlz = torch.sqrt(torch.clamp_min(1.0 - bu1, 0.0))
    wdf = [f * hlx + b * hly + n * hlz for f, b, n in ((fx, bx_, nx), (fy, by_, ny), (fz, bz_, nz))]

    din = _dot(dx, dy, dz, nx, ny, nz)
    wm = [dc - 2.0 * din * n for dc, n in ((dx, nx), (dy, ny), (dz, nz))]

    # dielectric (material.glsl:50-87 verbatim, incl. quirks)
    if ms.diel.shape[0]:
        ext_r, ext_g, ext_b, eta0 = _select_row(midx, ms.diel, 4)
    else:
        ext_r = ext_g = ext_b = torch.zeros_like(midx)
        eta0 = torch.ones_like(midx)
    eta_inv0 = 1.0 / eta0
    cos_i0 = -din
    flip = cos_i0 < 0.0
    eta = W(flip, eta_inv0, eta0)
    # inside-hit etaInv = fl(1/fl(1/eta)), the reference's double reciprocal
    eta_inv = W(flip, 1.0 / eta_inv0, eta_inv0)
    nnx, nny, nnz = W(flip, -nx, nx), W(flip, -ny, ny), W(flip, -nz, nz)
    cos_i = W(flip, -cos_i0, cos_i0)
    kk = 1.0 - eta_inv * eta_inv * (1.0 - cos_i * cos_i)
    tir = kk <= 0.0
    cos_o = torch.sqrt(torch.clamp_min(kk, 0.0))
    rho_par = (eta * cos_i - cos_o) / (eta * cos_i + cos_o)
    rho_orth = (cos_i - eta * cos_o) / (cos_i + eta * cos_o)
    f_r = 0.5 * (rho_par * rho_par + rho_orth * rho_orth)
    choose_reflect = bu1 < f_r
    dinn = _dot(dx, dy, dz, nnx, nny, nnz)
    refl = tir | choose_reflect
    wdl = [
        W(refl, dc - 2.0 * dinn * n, eta_inv * (dc - dinn * n) - cos_o * n)
        for dc, n in ((dx, nnx), (dy, nny), (dz, nnz))
    ]
    inside0 = cos_i0 > 0.0
    refracted = ~tir & ~choose_reflect
    inside_final = refracted ^ inside0

    is_mir = tag == TAG_MIRROR
    is_dl = tag == TAG_DIELECTRIC
    difish = is_dif | is_cb
    wo = [
        W(difish, a, W(is_mir, b, W(is_dl, c, dc)))
        for a, b, c, dc in zip(wdf, wm, wdl, (dx, dy, dz))
    ]
    spec_w = W(is_mir | is_dl, 1.0, 0.0)
    wr_ = W(is_dif, dcol[0], W(is_cb, cbr, spec_w))
    wg_ = W(is_dif, dcol[1], W(is_cb, cbg, spec_w))
    wb_ = W(is_dif, dcol[2], W(is_cb, cbb, spec_w))
    set_ext = is_dl & found & inside_final
    out["er"] = W(set_ext, ext_r, s["er"])
    out["eg"] = W(set_ext, ext_g, s["eg"])
    out["eb"] = W(set_ext, ext_b, s["eb"])

    consumed2 = found & difish
    consumed1 = found & is_dl & ~tir
    new_state = W(consumed2, stB, W(consumed1, stA, new_state))

    tr, tg, tb = W(found, tr * wr_, tr), W(found, tg * wg_, tg), W(found, tb * wb_, tb)
    out["ox"], out["oy"], out["oz"] = W(found, hx, ox), W(found, hy, oy), W(found, hz, oz)
    out["dx"], out["dy"], out["dz"] = W(found, wo[0], dx), W(found, wo[1], dy), W(found, wo[2], dz)
    out["tmin"] = W(found, _f(2.0 * M_EPS), s["tmin"])
    out["wd"] = W(found, (~difish).to(f32), s["wd"])

    # Russian roulette (render.glsl:137-144)
    rr = found & (s["bounce"] > 3)
    stC, u_rr = _randf(new_state)
    out["state"] = W(rr, stC, new_state)
    q = torch.minimum(torch.full_like(tr, _f(0.99)), torch.maximum(tr, torch.maximum(tg, tb)))
    kill = rr & (u_rr > q)
    keepq = rr & ~kill
    out["tr"], out["tg"], out["tb"] = W(keepq, tr / q, tr), W(keepq, tg / q, tg), W(keepq, tb / q, tb)
    out["Lr"], out["Lg"], out["Lb"] = Lr, Lg, Lb
    out["alive"] = (found & ~kill).to(f32)
    out["bounce"] = s["bounce"] + 1.0
    out["segs"] = s["segs"] + 1.0
    out["rows"] = s["rows"] + h["nit"] + nit_s
    return out


def _bounce_loop(ms, s, cap):
    """Bounce every lane while it is alive and under ``cap`` bounces. Each
    pass runs one bounce of the lanes still going (per-lane semantics)."""
    s = dict(s)
    while True:
        go = (s["alive"] > 0) & (s["bounce"] < cap)
        idx = torch.nonzero(go).flatten()
        if idx.numel() == 0:
            return s
        sub = _bounce(ms, {k: v[idx] for k, v in s.items()})
        for k in s:
            s[k] = s[k].index_put((idx,), sub[k])


def _pack(s):
    return torch.stack([s[ch] for ch in _STATE_CH]), to_bits(s["state"])


def _unpack(st, rng):
    s = {ch: st[i] for i, ch in enumerate(_STATE_CH)}
    s["state"] = from_bits(rng)
    return s


# ----------------------------------------------------------------------------
# kernel wrappers: CUDA tensor -> hand-written kernel, CPU tensor -> twin
# ----------------------------------------------------------------------------


def _scene_args(ms):
    return (
        ms.total_rows, ms.tbl_rows, ms.ntab, int(ms.analytic_mode),
        ms.n_analytic, ms.emitters.shape[0], ms.diffuse.shape[0],
        ms.cboard.shape[0], ms.diel.shape[0], ms.emissive.shape[0],
    )


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor on {device}")


def _launch(fn_name, ms, ins, n, cap):
    """Run ``mk_start``/``mk_resume`` of csrc/megakernel.cu on the current
    stream; returns the (N_STATE, n) state and the (n,) RNG bits."""
    from hijiki_tpu_torch.utils.build import load_library

    dev = ms.rows.device
    st = torch.empty((N_STATE, n), dtype=torch.float32, device=dev)
    rng = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        lib = load_library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn_name)(
            ms.rows.data_ptr(), ms.consts.data_ptr(), *_scene_args(ms),
            *[t.data_ptr() for t in ins], n, cap, st.data_ptr(), rng.data_ptr(),
            stream,
        )
        LAUNCHES[fn_name] += 1
        if rc != 0:
            raise RuntimeError(f"{fn_name} launch failed: CUDA error {rc}")
    return st, rng


def megakernel_start(ms: MegaScene, px, py, seeds, cap: int):
    """Camera launch (K1, replaces ``_megakernel_start``): raygen and
    bounces up to ``cap``. px/py (N,) f32, seeds (N,) int32 u32 bits.
    Returns (state (N_STATE, N) f32, rng (N,) int32 bits)."""
    n = px.shape[0]
    if px.device.type == "cuda":
        dev = ms.rows.device
        _check("px", px, torch.float32, (n,), dev)
        _check("py", py, torch.float32, (n,), dev)
        _check("seeds", seeds, torch.int32, (n,), dev)
        return _launch("mk_start", ms, [px, py, seeds], n, cap)
    return megakernel_start_plain(ms, px, py, seeds, cap)


def megakernel_start_plain(ms: MegaScene, px, py, seeds, cap: int):
    """The plain twin of K1 (any device)."""
    return _pack(_bounce_loop(ms, _camera_init(ms, px, py, from_bits(seeds)), cap))


def megakernel_resume(ms: MegaScene, st, rng, cap: int):
    """Resume launch (K2, replaces ``_megakernel_resume``): continue the
    paths of a packed state up to ``cap`` bounces."""
    n = st.shape[1]
    if st.device.type == "cuda":
        dev = ms.rows.device
        _check("state", st, torch.float32, (N_STATE, n), dev)
        _check("rng", rng, torch.int32, (n,), dev)
        return _launch("mk_resume", ms, [st, rng], n, cap)
    return megakernel_resume_plain(ms, st, rng, cap)


def megakernel_resume_plain(ms: MegaScene, st, rng, cap: int):
    """The plain twin of K2 (any device)."""
    return _pack(_bounce_loop(ms, _unpack(st, rng), cap))


# ----------------------------------------------------------------------------
# drivers
# ----------------------------------------------------------------------------


def render_tiles(ms: MegaScene, px, py, seeds, *, max_bounces: int = 1000):
    """Whole paths in one camera launch to ``max_bounces`` (the counterpart
    of the TPU's single-launch ``render_tiles``). Returns (total (N,3),
    normal (N,3), depth (N,), state (N,))."""
    st, rng = megakernel_start(ms, px, py, seeds, max_bounces)
    return st[15:18].T, st[20:23].T, st[19], rng


def _phase_caps(max_bounces, phase_bounces, phase_shrink):
    """``render_waves``' cap normalization: clamp, pair each cap with its
    shrink, drop resume phases that cannot trace further."""
    caps = [min(c, max_bounces) for c in list(phase_bounces) + [max_bounces]]
    shrinks = list(phase_shrink) + [4] * (len(caps) - 1 - len(phase_shrink))
    inc = []
    for c, s in zip(caps[1:], shrinks):
        if c > caps[0] and (not inc or c > inc[-1][0]):
            inc.append((c, s))
    return [caps[0]] + [c for c, _ in inc], [s for _, s in inc]


def _run_compaction_phases(ms, caps, shrinks, flat, rngf, orig, res, res_state):
    """The survivor phases: compact + coherence-sort the alive lanes, resume
    at each cap, scatter the results into ``res``/``res_state`` at ``orig``.
    Returns (res, res_state, overflow tensor)."""
    dev = flat.device
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    n_lanes = flat.shape[1]
    root_min = ms.root_min
    root_span = torch.clamp_min(ms.root_max - root_min, 1e-6)
    result_ch = list(_RESULT_CH)
    for pi, cap in enumerate(caps):
        n_next = max(TILE, -(-(n_lanes // shrinks[pi]) // TILE) * TILE)
        alive = flat[0] > 0
        alive_i = alive.long()
        n_alive = alive_i.sum()
        overflow = overflow + torch.clamp_min(n_alive - n_next, 0)
        if n_lanes > 65536:
            # stable partition: survivors keep their order
            rank_alive = torch.cumsum(alive_i, 0) - 1
            rank_dead = torch.cumsum(1 - alive_i, 0) - 1 + n_alive
            pos = torch.where(alive, rank_alive, rank_dead)
            inv = torch.empty_like(pos).scatter_(0, pos, torch.arange(n_lanes, device=dev))
            order = inv[:n_next]
        else:
            # small survivor sets: full coherence sort (origin cell + octant)
            q = [
                torch.clamp(((flat[2 + a] - root_min[a]) / root_span[a] * 8).to(torch.int32), 0, 7)
                for a in range(3)
            ]
            octant = (flat[5] > 0).int() + 2 * (flat[6] > 0).int() + 4 * (flat[7] > 0).int()
            key = torch.where(alive, octant + 8 * (q[0] + 8 * (q[1] + 8 * q[2])), 1 << 20)
            order = torch.argsort(key, stable=True)[:n_next]
        flat, rngf, orig = flat[:, order].contiguous(), rngf[order].contiguous(), orig[order]
        flat, rngf = megakernel_resume(ms, flat, rngf, cap)
        res[:, orig] = flat[result_ch]
        res_state[orig] = rngf
        n_lanes = n_next
    return res, res_state, overflow


def render_waves(
    ms: MegaScene,
    px,
    py,
    seeds,
    *,
    max_bounces: int = 1000,
    phase_bounces: tuple = (5, 12, 48),
    phase_shrink: tuple = (2, 4, 4),
):
    """Phased wavefront render (``render_waves``): a camera launch to
    ``phase_bounces[0]``, then compaction phases that resume the survivors
    at the later caps, the last one to ``max_bounces``. Survivor capacity
    after phase k is N / phase_shrink[k]; paths beyond it are dropped and
    counted in ``overflow`` (the renderer re-renders such sweeps).

    Returns (total (N,3), normal (N,3), depth (N,), state (N,), overflow (),
    segs (N,), rows (N,), albedo (N,3)).
    """
    n_req = px.shape[0]
    pad = (-n_req) % TILE
    if pad:
        # dummy rays (duplicates of ray 0), dropped from the results
        px = torch.cat([px, px[:1].expand(pad)])
        py = torch.cat([py, py[:1].expand(pad)])
        seeds = torch.cat([seeds, torch.zeros(pad, dtype=seeds.dtype, device=seeds.device)])
    n = px.shape[0]
    caps, shrinks = _phase_caps(max_bounces, phase_bounces, phase_shrink)
    flat, rngf = megakernel_start(ms, px.contiguous(), py.contiguous(), seeds.contiguous(), caps[0])
    res = flat[list(_RESULT_CH)].clone()
    res_state = rngf.clone()
    orig = torch.arange(n, device=px.device)
    res, res_state, overflow = _run_compaction_phases(
        ms, caps[1:], shrinks, flat, rngf, orig, res, res_state
    )
    res = res[:, :n_req]
    return (
        res[0:3].T, res[3:6].T, res[6], res_state[:n_req], overflow,
        res[7], res[8], res[9:12].T,
    )


# ----------------------------------------------------------------------------
# state carried across from the TPU kernel's layout
# ----------------------------------------------------------------------------


def state_from_reference(st, rng, device="cpu"):
    """The JAX kernel's (T, N_STATE, 8, P) f32 state and (T, 1, 8, P) u32
    RNG -> the port's (N_STATE, N) f32 and (N,) int32 bits (lane order
    kept)."""
    st = np.array(st, np.float32)
    n = st.shape[0] * st.shape[2] * st.shape[3]
    flat = np.moveaxis(st, 1, 0).reshape(N_STATE, n)
    r = np.array(rng, np.uint32).reshape(n).view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(flat)).to(device), torch.from_numpy(r).to(device)


def state_to_reference(st, rng, packet: int = 128):
    """Inverse of ``state_from_reference`` (numpy arrays, 8 x ``packet``
    lane tiles)."""
    st = st.detach().cpu().numpy().astype(np.float32)
    n = st.shape[1]
    t = n // (8 * packet)
    out = np.moveaxis(st.reshape(N_STATE, t, 8, packet), 0, 1)
    r = rng.detach().cpu().numpy().view(np.uint32).reshape(t, 1, 8, packet)
    return np.ascontiguousarray(out), r
