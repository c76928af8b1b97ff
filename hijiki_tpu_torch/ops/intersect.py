"""Ray-scene intersection: the unified primitive test, brute force, the
lockstep threaded-BVH walk and the trace-row walks.

Port of ``hijiki_tpu/ops/intersect.py`` (the reference's
``shader/scene.glsl:97-175``): every primitive is a unified (a, b, c, kind)
record tested by one branchless vectorized test covering spheres,
parallelogram quads and triangles, and traversal is the reference's
stackless exit-index walk run in lockstep over the ray batch.

``intersect_rows``/``occluded_rows`` walk the merged trace-row table
through ``ops/pallas_traverse.py``: on a CUDA tensor that launches K6
(``csrc/traverse.cu``), on a CPU tensor its plain twin. ``intersect_bvh``
and ``intersect_brute`` are plain torch on every device (XLA code in the
JAX package, not Pallas kernels).

Rounding: products and sums are separate f32 operations in the JAX
source's order (``a0*b0 + a1*b1 + a2*b2``, ``sqrt`` of that for a norm).
XLA's CPU backend contracts ``a*b + c`` into FMAs and torch does not, so
the two packages can differ in the last bits (and, rarely, in a t-tie).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from hijiki_tpu_torch.scene.compile import KIND_SPHERE, KIND_TRIANGLE

M_EPS = float(np.float32(1e-4))
M_PI = float(np.float32(3.1415926535897932384626433832795))
# f32-finite "-inf" for the tmax of lanes that must not walk (K6 skips a
# ray whose tmax < tmin)
NEG_BIG = -3.0e38


class Hit(NamedTuple):
    """SoA closest-hit record for a ray batch."""

    valid: torch.Tensor  # (N,) bool
    t: torch.Tensor  # (N,) f32
    prim_slot: torch.Tensor  # (N,) int — BVH-reordered primitive slot
    shape_id: torch.Tensor  # (N,) int — global shape index (materials key)
    u: torch.Tensor  # (N,) f32 barycentric/param u
    v: torch.Tensor  # (N,) f32
    # material tag / per-type index when the traversal returns them with
    # the hit (the packet path); None -> shading gathers materials[shape_id]
    tag: Optional[torch.Tensor] = None
    midx: Optional[torch.Tensor] = None


class Its(NamedTuple):
    """Populated intersection (``Intersection``, shader/render.glsl:39-46)."""

    valid: torch.Tensor
    t: torch.Tensor
    shape_id: torch.Tensor
    p: torch.Tensor  # (N,3)
    n: torch.Tensor  # (N,3) shading normal
    uv: torch.Tensor  # (N,2)
    frame_t: torch.Tensor  # (N,3) tangent
    frame_b: torch.Tensor  # (N,3) bitangent


def dot(a, b):
    """Sum over the last axis of a*b, in jnp.sum's order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    """jnp.cross over the last axis."""
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def norm(a, keepdim: bool = False):
    """jnp.linalg.norm over the last axis: sqrt(x*x + y*y + z*z)."""
    n = torch.sqrt(dot(a, a))
    return n.unsqueeze(-1) if keepdim else n


def div_const(x, c: float):
    """x / c as a true f32 division (torch's CUDA division by a Python
    number multiplies by its reciprocal, which rounds differently)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def gather(table, idx):
    """``table[idx]`` with JAX's index rules: a negative index wraps once,
    then the index is clamped into range (torch raises or device-asserts
    on an index out of range)."""
    k = table.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + k, idx).clamp(0, k - 1)
    return table[idx]


def intersect_unified(o, d, tmin, tmax, a, b, c, kind):
    """Test rays against unified primitives (broadcastable).

    Parallelograms/triangles: the Lagrange-identity test of
    ``shader/shapes/quad.glsl:7-25`` / ``triangle.glsl:15-52``; spheres: the
    near/far quadratic of ``shader/shapes/sphere.glsl:18-41``.
    Returns (hit, t, u, v); for spheres u = v = 0.
    """
    n = cross(b, c)
    ro = o - a
    q = cross(ro, d)
    dd = 1.0 / dot(d, n)
    u = dd * dot(-q, c)
    v = dd * dot(q, b)
    t_pq = dd * dot(-n, ro)
    in_tri = (u >= 0) & (v >= 0) & (u + v <= 1.0)
    in_quad = (u >= 0) & (u <= 1.0) & (v >= 0) & (v <= 1.0)
    ok_pq = torch.where(kind == KIND_TRIANGLE, in_tri, in_quad)
    ok_pq = ok_pq & (tmin <= t_pq) & (t_pq <= tmax)

    radius = b[..., 0]
    sb = 2.0 * dot(d, ro)
    sc = dot(ro, ro) - radius * radius
    disc = sb * sb - 4.0 * sc
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = -0.5 * (sb + sq)
    t1 = -0.5 * (sb - sq)
    ok0 = (tmin <= t0) & (t0 <= tmax)
    ok1 = (tmin <= t1) & (t1 <= tmax)
    t_s = torch.where(ok0, t0, t1)
    ok_s = (disc >= 0.0) & (ok0 | ok1)

    is_sphere = kind == KIND_SPHERE
    hit = torch.where(is_sphere, ok_s, ok_pq)
    t = torch.where(is_sphere, t_s, t_pq)
    return hit, t, torch.where(is_sphere, 0.0, u), torch.where(is_sphere, 0.0, v)


# rays x prims per brute-force chunk: bounds the (rays, prims) temporaries
# (1M rays x 6,274 prims would not fit in device memory)
BRUTE_CHUNK = 1 << 21


def intersect_brute(o, d, tmin, tmax, active=None, *, scene) -> Hit:
    """Closest hit by testing every primitive (``shader/scene.glsl:134-158``
    minus the >100-primitive failsafe), in chunks of rays. Winner = minimum
    t, ties to the lowest slot."""
    P = scene.num_prims
    n = o.shape[0]
    step = max(1, BRUTE_CHUNK // P)
    pa, pb, pc = scene.prim_a[:P], scene.prim_b[:P], scene.prim_c[:P]
    pk = scene.prim_kind[:P]
    parts = []
    for s in range(0, n, step):
        e = min(n, s + step)
        hit, t, u, v = intersect_unified(
            o[s:e, None, :], d[s:e, None, :], tmin[s:e, None], tmax[s:e, None],
            pa, pb, pc, pk,
        )
        t_masked = torch.where(hit, t, float("inf"))
        slot = torch.argmin(t_masked, dim=-1, keepdim=True)
        parts.append([x.gather(-1, slot)[:, 0] for x in (hit, t, u, v)] + [slot[:, 0]])
    valid, t, u, v, slot = (torch.cat(p) for p in zip(*parts))
    return Hit(valid=valid, t=t, prim_slot=slot, shape_id=gather(scene.prim_shape_id, slot),
               u=u, v=v)


def occluded_brute(o, d, tmin, tmax, active=None, *, scene):
    return intersect_brute(o, d, tmin, tmax, scene=scene).valid


def _slab(nmin, nmax, inv_d, t_off, best_t, tmin):
    """The AABB slab test (``shader/scene.glsl:118-130``) with M_EPS slack."""
    tneg = nmin * inv_d + t_off
    tpos = nmax * inv_d + t_off
    t0 = torch.minimum(tneg, tpos).amax(-1)  # NaN-propagating, as jnp.max
    t1 = torch.maximum(tneg, tpos).amin(-1)
    return (t0 < t1 + M_EPS) & (t0 < best_t) & (t1 > tmin)


def _bvh_walk(o, d, tmin, tmax, active, scene, leaf_size, any_hit):
    """The lockstep stackless BVH walk of ``intersect_bvh``/``occluded_bvh``:
    per-ray node cursor; interior nodes slab-test to ``cur+1`` or ``exit``,
    leaves test their prims and exit."""
    num_nodes = scene.num_bvh_nodes
    P = scene.num_prims
    inv_d = 1.0 / d
    t_off = -o * inv_d
    cur = torch.zeros(o.shape[:-1], dtype=torch.int64, device=o.device)
    if active is not None:
        cur = torch.where(active, cur, num_nodes)
    best_t = tmax.clone()
    best_slot = torch.full_like(cur, -1)
    best_u = torch.zeros_like(tmax)
    best_v = torch.zeros_like(tmax)
    hit = torch.zeros_like(cur, dtype=torch.bool)
    while True:
        act = cur < num_nodes
        if any_hit:
            act = act & ~hit
        if not bool(act.any()):
            break
        idx = torch.clamp_max(cur, num_nodes - 1)
        first = scene.bvh_first[idx].long()
        count = scene.bvh_count[idx].long()
        nexit = scene.bvh_exit[idx].long()
        is_leaf = count > 0
        aabb_hit = _slab(scene.bvh_aabb_min[idx], scene.bvh_aabb_max[idx], inv_d, t_off,
                         tmax if any_hit else best_t, tmin)
        for k in range(leaf_size):
            pslot = torch.clamp(first + k, 0, P - 1)
            phit, pt, pu, pv = intersect_unified(
                o, d, tmin, tmax if any_hit else best_t,
                scene.prim_a[pslot], scene.prim_b[pslot], scene.prim_c[pslot],
                scene.prim_kind[pslot],
            )
            if any_hit:
                hit = hit | (act & is_leaf & (k < count) & phit)
                continue
            accept = act & is_leaf & (k < count) & phit & (pt < best_t)
            best_t = torch.where(accept, pt, best_t)
            best_slot = torch.where(accept, pslot, best_slot)
            best_u = torch.where(accept, pu, best_u)
            best_v = torch.where(accept, pv, best_v)
        nxt = torch.where(is_leaf | ~aabb_hit, nexit, cur + 1)
        if any_hit:
            cur = torch.where(hit, num_nodes, torch.where(act, nxt, cur))
        else:
            cur = torch.where(act, nxt, cur)
    return hit, best_t, best_slot, best_u, best_v


def intersect_bvh(o, d, tmin, tmax, active=None, *, scene, leaf_size: int = 1) -> Hit:
    """Lockstep stackless BVH walk over the ray batch (closest hit)."""
    _, best_t, best_slot, u, v = _bvh_walk(o, d, tmin, tmax, active, scene, leaf_size, False)
    valid = best_slot >= 0
    slot = torch.clamp_min(best_slot, 0)
    return Hit(valid=valid, t=best_t, prim_slot=slot,
               shape_id=gather(scene.prim_shape_id, slot), u=u, v=v)


def occluded_bvh(o, d, tmin, tmax, active=None, *, scene, leaf_size: int = 1):
    """Any-hit query for shadow rays with per-lane early exit; inactive
    lanes skip traversal and report unoccluded."""
    return _bvh_walk(o, d, tmin, tmax, active, scene, leaf_size, True)[0]


def intersect_rows(o, d, tmin, tmax, active=None, *, scene) -> Hit:
    """Closest hit over the merged trace-row table (K6 on a CUDA tensor, its
    twin on a CPU tensor). As in JAX, an inactive lane keeps t = tmax and
    the Hit carries no material: shading gathers ``materials[shape_id]``."""
    from hijiki_tpu_torch.ops.pallas_traverse import traverse_packets

    tm = tmax if active is None else torch.where(active, tmax, NEG_BIG)
    best_t, slot, u, v, _, _ = traverse_packets(scene.trace_rows, o, d, tmin, tm)
    if active is not None:
        best_t = torch.where(active, best_t, tmax)
    valid = slot >= 0
    slot = torch.clamp_min(slot, 0)
    return Hit(valid=valid, t=best_t, prim_slot=slot,
               shape_id=gather(scene.prim_shape_id, slot), u=u, v=v)


def occluded_rows(o, d, tmin, tmax, active=None, *, scene):
    """Any-hit query over the trace-row table (K6's any-hit walk). As JAX's
    ``occluded_rows``, a hit at exactly tmax occludes (the inclusive mode)."""
    from hijiki_tpu_torch.ops.pallas_traverse import traverse_packets

    tm = tmax if active is None else torch.where(active, tmax, NEG_BIG)
    return traverse_packets(scene.trace_rows, o, d, tmin, tm, any_hit=True,
                            inclusive=True)[1] >= 0


def populate_intersection(o, d, hit: Hit, scene) -> Its:
    """Shading data for the winning primitive (masked version of
    ``populate{Sphere,Quad,Triangle}Intersection``, ``shader/scene.glsl:160-174``)
    with exact ``atan2``/``asin`` (the megakernel uses polynomials)."""
    slot = hit.prim_slot
    a = scene.prim_a[slot]
    b = scene.prim_b[slot]
    c = scene.prim_c[slot]
    kind = scene.prim_kind[slot]
    tri = scene.prim_tri[slot].long()

    p = o + hit.t[..., None] * d

    # sphere (shader/shapes/sphere.glsl:43-52)
    n_s = (p - a) / b[..., 0:1]
    t_s = torch.stack([-n_s[..., 2], torch.zeros_like(n_s[..., 0]), n_s[..., 0]], dim=-1)
    t_s = t_s / norm(t_s, keepdim=True)
    b_s = cross(n_s, t_s)
    uv_s_x = 0.5 + div_const(torch.atan2(n_s[..., 2], n_s[..., 0]), 2.0 * M_PI)
    uv_s_x = torch.where(torch.isnan(uv_s_x), 0.0, uv_s_x)  # NaN guard, sphere.glsl:49-51
    uv_s_y = 0.5 + div_const(torch.asin(torch.clamp(n_s[..., 1], -1.0, 1.0)), M_PI)
    uv_s = torch.stack([uv_s_x, uv_s_y], dim=-1)

    # quad (shader/shapes/quad.glsl:27-32): frame from normalized edges
    t_q = b / norm(b, keepdim=True)
    b_q = c / norm(c, keepdim=True)
    n_q = cross(t_q, b_q)
    uv_q = torch.stack([hit.u, hit.v], dim=-1)

    # triangle (shader/shapes/triangle.glsl:54-78): smooth normal + UV
    lam0 = 1.0 - hit.u - hit.v
    vn, vuv = scene.vtx_normals, scene.vtx_uvs
    t0, t1, t2 = tri[..., 0], tri[..., 1], tri[..., 2]
    n_t = vn[t0] * lam0[..., None] + vn[t1] * hit.u[..., None] + vn[t2] * hit.v[..., None]
    n_t = n_t / norm(n_t, keepdim=True)
    uv_t = vuv[t0] * lam0[..., None] + vuv[t1] * hit.u[..., None] + vuv[t2] * hit.v[..., None]
    # bitangent seed (0, 1, 0) where |n.x| > |n.y|, else (1, 0, 0)
    gt = torch.abs(n_t[..., 0]) > torch.abs(n_t[..., 1])
    bt_seed = torch.stack([torch.where(gt, 0.0, 1.0), torch.where(gt, 1.0, 0.0),
                           torch.zeros_like(lam0)], dim=-1)
    t_t = cross(n_t, bt_seed)
    t_t = t_t / norm(t_t, keepdim=True)
    b_t = cross(n_t, t_t)

    is_sphere = (kind == KIND_SPHERE)[..., None]
    is_tri = (kind == KIND_TRIANGLE)[..., None]
    n = torch.where(is_sphere, n_s, torch.where(is_tri, n_t, n_q))
    tt = torch.where(is_sphere, t_s, torch.where(is_tri, t_t, t_q))
    bb = torch.where(is_sphere, b_s, torch.where(is_tri, b_t, b_q))
    uv = torch.where(is_sphere, uv_s, torch.where(is_tri, uv_t, uv_q))
    return Its(valid=hit.valid, t=hit.t, shape_id=hit.shape_id, p=p, n=n, uv=uv,
               frame_t=tt, frame_b=bb)
