"""Scalar reference integrator — the slow oracle.

A direct per-ray numpy-f32 transcription of the reference megakernel
(``shader/render.glsl:81-146`` plus its callees), structured like the GLSL:
one Python loop per path, data-dependent control flow, RNG consumed inline.
A copy of ``hijiki_tpu/ops/oracle.py`` on the port's host-side
``CompiledScene`` (numpy arrays, or tensors that ``host_scene`` moves to
numpy once at the entry), with its own numpy copy of the reference RNG
(the port's ``ops/rng.py`` is torch). The equal-seed gate holds the port's
drivers to it (``tests/test_torch_oracle.py``, ``chip_smoke.py``).

Not a performance path — tens of rays, not millions
(``ops/oracle_native.py`` runs the same paths at C speed).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hijiki_tpu_torch.scene.compile import CompiledScene, KIND_SPHERE, KIND_TRIANGLE
from hijiki_tpu_torch.scene.model import (
    MATERIAL_TAG_SHIFT,
    TAG_DIELECTRIC,
    TAG_DIFFUSE,
    TAG_DIFFUSECBOARD,
    TAG_EMISSIVE,
    TAG_MIRROR,
)

F = np.float32
M_EPS = F(1e-4)
M_PI = F(3.1415926535897932384626433832795)


def _f3(*args):
    return np.array(args, dtype=np.float32).reshape(3)


def _normalize(v):
    return v / F(np.linalg.norm(v).astype(np.float32))


def _wang_hash(seed):
    """Thomas Wang's integer hash on u32 (``shader/rand.glsl:9-16``): the
    numpy path of ``hijiki_tpu/ops/rng.py::wang_hash``."""
    seed = np.uint32(seed) if np.isscalar(seed) else seed
    seed = (seed ^ np.uint32(61)) ^ (seed >> np.uint32(16))
    seed = seed * np.uint32(9)
    seed = seed ^ (seed >> np.uint32(4))
    seed = seed * np.uint32(0x27D4EB2D)
    seed = seed ^ (seed >> np.uint32(15))
    return seed


def _rand_uniform_float(state):
    """One xorshift32 step (``shader/rand.glsl:2-7``) and its draw,
    float(u32) * 2^-32 rounded to nearest f32 (``rand.glsl:18-20``):
    returns (new state, draw)."""
    state = state ^ (state << np.uint32(13))
    state = state ^ (state >> np.uint32(17))
    state = state ^ (state << np.uint32(5))
    return state, state.astype(np.float32) * np.float32(1.0 / 4294967296.0)


def host_scene(cs: CompiledScene) -> CompiledScene:
    """``cs`` with every tensor field as a numpy array (a scene of
    ``to_device``: copied to the host once); a numpy scene as it is."""
    import torch

    moved = {f.name: getattr(cs, f.name).cpu().numpy() for f in dataclasses.fields(cs)
             if isinstance(getattr(cs, f.name), torch.Tensor)}
    return dataclasses.replace(cs, **moved) if moved else cs


class _Rng:
    def __init__(self, seed: int):
        with np.errstate(over="ignore"):
            self.state = _wang_hash(np.uint32(seed))
        self.draws = 0

    def uniform(self) -> np.float32:
        with np.errstate(over="ignore"):
            self.state, f = _rand_uniform_float(self.state)
        self.draws += 1
        return F(f)


def _intersect_prim(o, d, tmin, tmax, scene: CompiledScene, slot: int):
    """Unified primitive test, scalar: mirrors intersect.intersect_unified."""
    a = np.asarray(scene.prim_a[slot], np.float32)
    b = np.asarray(scene.prim_b[slot], np.float32)
    c = np.asarray(scene.prim_c[slot], np.float32)
    kind = int(scene.prim_kind[slot])
    if kind == KIND_SPHERE:
        r = b[0]
        l = o - a
        sb = F(2.0) * F(np.dot(d, l))
        sc = F(np.dot(l, l)) - r * r
        disc = sb * sb - F(4.0) * sc
        if disc < 0:
            return None
        sq = F(np.sqrt(disc))
        t0 = F(-0.5) * (sb + sq)
        if tmin <= t0 <= tmax:
            return (t0, F(0.0), F(0.0))
        t1 = F(-0.5) * (sb - sq)
        if tmin <= t1 <= tmax:
            return (t1, F(0.0), F(0.0))
        return None
    n = np.cross(b, c).astype(np.float32)
    ro = (o - a).astype(np.float32)
    q = np.cross(ro, d).astype(np.float32)
    denom = F(np.dot(d, n))
    dd = F(1.0) / denom
    u = dd * F(np.dot(-q, c))
    v = dd * F(np.dot(q, b))
    if kind == KIND_TRIANGLE:
        if not (u >= 0 and v >= 0 and u + v <= 1):
            return None
    else:
        if not (0 <= u <= 1 and 0 <= v <= 1):
            return None
    t = dd * F(np.dot(-n, ro))
    if tmin <= t <= tmax:
        return (t, u, v)
    return None


def _intersect_scene(o, d, tmin, tmax, scene: CompiledScene):
    best = None
    best_t = tmax
    for slot in range(scene.num_prims):
        res = _intersect_prim(o, d, tmin, best_t, scene, slot)
        if res is not None and res[0] < best_t:
            best_t = res[0]
            best = (slot, *res)
    return best


def _populate(o, d, t, slot, u, v, scene: CompiledScene):
    a = np.asarray(scene.prim_a[slot], np.float32)
    b = np.asarray(scene.prim_b[slot], np.float32)
    c = np.asarray(scene.prim_c[slot], np.float32)
    kind = int(scene.prim_kind[slot])
    p = (o + t * d).astype(np.float32)
    if kind == KIND_SPHERE:
        n = ((p - a) / b[0]).astype(np.float32)
        tang = _normalize(_f3(-n[2], 0.0, n[0]))
        bt = np.cross(n, tang).astype(np.float32)
        uvx = F(0.5) + F(np.arctan2(n[2], n[0])) / (F(2.0) * M_PI)
        if np.isnan(uvx):
            uvx = F(0.0)
        uvy = F(0.5) + F(np.arcsin(np.clip(n[1], -1, 1))) / M_PI
        return p, n, np.array([uvx, uvy], np.float32), tang, bt
    if kind == KIND_TRIANGLE:
        tri = np.asarray(scene.prim_tri[slot])
        lam = np.array([1.0 - u - v, u, v], np.float32)
        vn = np.asarray(scene.vtx_normals)
        vuv = np.asarray(scene.vtx_uvs)
        n = _normalize(
            (vn[tri[0]] * lam[0] + vn[tri[1]] * lam[1] + vn[tri[2]] * lam[2]).astype(
                np.float32
            )
        )
        uv = (vuv[tri[0]] * lam[0] + vuv[tri[1]] * lam[1] + vuv[tri[2]] * lam[2]).astype(
            np.float32
        )
        bt_seed = _f3(0, 1, 0) if abs(n[0]) > abs(n[1]) else _f3(1, 0, 0)
        tang = _normalize(np.cross(n, bt_seed).astype(np.float32))
        bt = np.cross(n, tang).astype(np.float32)
        return p, n, uv, tang, bt
    tang = _normalize(b)
    bt = _normalize(c)
    n = np.cross(tang, bt).astype(np.float32)
    return p, n, np.array([u, v], np.float32), tang, bt


def _checkerboard(c1, c2, scale, uv):
    st = (F(0.5) * uv / scale).astype(np.float32)
    st = st - np.floor(st)
    if (st[0] < 0.5) ^ (st[1] < 0.5):
        return np.asarray(c2, np.float32)
    return np.asarray(c1, np.float32)


def _sample_emitter(scene: CompiledScene, r: _Rng, ref_p):
    u_pick = r.uniform()
    emitter = 0
    for i in range(scene.num_emitters):
        if u_pick < scene.emitter_cdf[i]:
            emitter = i
            break
    shape = int(scene.emitter_shape[emitter])
    em_pdf = F(scene.emitter_pdf[emitter])
    u1, u2 = r.uniform(), r.uniform()
    S, Q = scene.num_spheres, scene.num_quads
    if shape < S:
        sp = np.asarray(scene.sphere_pos_radius[shape], np.float32)
        z = F(2.0) * u1 - F(1.0)
        theta = F(2.0) * M_PI * u2
        rr_ = F(np.sqrt(F(1.0) - z * z))
        n_s = _f3(rr_ * np.cos(theta), rr_ * np.sin(theta), z)
        p_s = sp[:3] + sp[3] * n_s
        pdf_s = F(1.0) / (sp[3] * sp[3] * F(4.0) * M_PI)
    elif shape < S + Q:
        qi = shape - S
        qo = np.asarray(scene.quad_origin[qi], np.float32)
        e1 = np.asarray(scene.quad_edge1[qi], np.float32)
        e2 = np.asarray(scene.quad_edge2[qi], np.float32)
        n_s = np.cross(e1, e2).astype(np.float32)
        area = F(np.linalg.norm(n_s))
        n_s = n_s / area
        p_s = qo + u1 * e1 + u2 * e2
        pdf_s = F(1.0) / area
    else:
        ti = shape - S - Q
        tri = np.asarray(scene.tri_indices[ti])
        vp, vn = np.asarray(scene.vtx_positions), np.asarray(scene.vtx_normals)
        if u1 + u2 > 1:
            u1 = F(1.0) - u2  # fold quirk: v unchanged (rand.glsl:44-47)
        lam = np.array([u1, u2, F(1.0) - u1 - u2], np.float32)
        ab = (vp[tri[1]] - vp[tri[0]]).astype(np.float32)
        ac = (vp[tri[2]] - vp[tri[0]]).astype(np.float32)
        area = F(np.linalg.norm(np.cross(ab, ac))) / F(2.0)
        n_s = _normalize(
            (vn[tri[0]] * lam[0] + vn[tri[1]] * lam[1] + vn[tri[2]] * lam[2]).astype(
                np.float32
            )
        )
        p_s = (vp[tri[0]] * lam[0] + vp[tri[1]] * lam[1] + vp[tri[2]] * lam[2]).astype(
            np.float32
        )
        pdf_s = F(1.0) / area

    handle = int(scene.materials[shape])
    midx = handle & ((1 << MATERIAL_TAG_SHIFT) - 1)
    power = np.asarray(scene.emissive_power[midx], np.float32)
    dvec = (p_s - ref_p).astype(np.float32)
    dist = F(np.linalg.norm(dvec))
    direction = dvec / dist
    cos_theta = F(-np.dot(direction, n_s))
    shadow = dict(o=ref_p, d=direction, tmin=F(2.0) * M_EPS, tmax=dist - M_EPS)
    if cos_theta < 0:
        return np.zeros(3, np.float32), shadow
    pdf = em_pdf * pdf_s * dist * dist / cos_theta
    return power / pdf, shadow


def _eval_bsdf(scene, handle, wi, n, uv):
    tag = handle >> MATERIAL_TAG_SHIFT
    idx = handle & ((1 << MATERIAL_TAG_SHIFT) - 1)
    if tag == TAG_DIFFUSE:
        color = np.asarray(scene.diffuse_color[idx], np.float32)
        return F(np.dot(n, wi)) * color / M_PI
    if tag == TAG_DIFFUSECBOARD:
        color = _checkerboard(
            scene.cb_color1[idx], scene.cb_color2[idx], np.asarray(scene.cb_scale[idx]), uv
        )
        return F(np.dot(n, wi)) * color / M_PI
    return np.zeros(3, np.float32)


def _reflect(i, n):
    return (i - F(2.0) * F(np.dot(n, i)) * n).astype(np.float32)


def _sample_bsdf(scene, handle, wi, n, uv, frame_t, frame_b, r: _Rng, extinction):
    tag = handle >> MATERIAL_TAG_SHIFT
    idx = handle & ((1 << MATERIAL_TAG_SHIFT) - 1)
    if tag in (TAG_DIFFUSE, TAG_DIFFUSECBOARD):
        u1, u2 = r.uniform(), r.uniform()
        rad = F(np.sqrt(u1))
        theta = F(2.0) * M_PI * u2
        lx, ly = rad * F(np.cos(theta)), rad * F(np.sin(theta))
        lz = F(np.sqrt(max(F(0.0), F(1.0) - u1)))
        wo = (frame_t * lx + frame_b * ly + n * lz).astype(np.float32)
        if tag == TAG_DIFFUSE:
            return wo, np.asarray(scene.diffuse_color[idx], np.float32), extinction
        return (
            wo,
            _checkerboard(
                scene.cb_color1[idx], scene.cb_color2[idx], np.asarray(scene.cb_scale[idx]), uv
            ),
            extinction,
        )
    if tag == TAG_MIRROR:
        return _reflect(wi, n), np.ones(3, np.float32), extinction
    if tag == TAG_DIELECTRIC:
        ext_eta = np.asarray(scene.dielectric_ext_eta[idx], np.float32)
        eta = ext_eta[3]
        eta_inv = F(1.0) / eta
        cos_i = F(-np.dot(n, wi))
        normal = n
        inside = cos_i > 0
        if cos_i < 0:
            eta, eta_inv = eta_inv, F(1.0) / eta_inv
            normal = -normal
            cos_i = -cos_i
        k = F(1.0) - eta_inv * eta_inv * (F(1.0) - cos_i * cos_i)
        if k <= 0:
            wo = _reflect(wi, normal)
        else:
            cos_o = F(np.sqrt(k))
            rho_par = (eta * cos_i - cos_o) / (eta * cos_i + cos_o)
            rho_orth = (cos_i - eta * cos_o) / (cos_i + eta * cos_o)
            f_r = F(0.5) * (rho_par * rho_par + rho_orth * rho_orth)
            if r.uniform() < f_r:
                wo = _reflect(wi, normal)
            else:
                inside = not inside
                parallel = (wi - F(np.dot(wi, normal)) * normal).astype(np.float32)
                wo = (eta_inv * parallel - F(np.sqrt(k)) * normal).astype(np.float32)
        if inside:
            extinction = ext_eta[:3].copy()
        return wo, np.ones(3, np.float32), extinction
    # emissive: zero weight, wo := wi (see ops/bsdf.py docstring)
    return wi, np.zeros(3, np.float32), extinction


def integrate_ray_oracle(scene: CompiledScene, o, d, seed: int, max_bounces: int = 1000):
    """Trace one path; returns dict(total, normal, depth, state, draws).
    ``scene``: a host-side CompiledScene (its tensors, if any, are copied to
    numpy here, before the path's loop)."""
    scene = host_scene(scene)
    r = _Rng(seed)
    o = np.asarray(o, np.float32).copy()
    d = np.asarray(d, np.float32).copy()
    tmin, tmax = M_EPS, F(np.inf)
    total = np.zeros(3, np.float32)
    throughput = np.ones(3, np.float32)
    extinction = np.zeros(3, np.float32)
    was_discrete = True
    depth = F(0.0)
    normal = np.zeros(3, np.float32)

    for bounce in range(max_bounces):
        best = _intersect_scene(o, d, tmin, tmax, scene)
        if best is None:
            break
        slot, t, u, v = best
        p, n, uv, frame_t, frame_b = _populate(o, d, t, slot, u, v, scene)
        if bounce == 0:
            depth, normal = t, n.copy()
        shape_id = int(scene.prim_shape_id[slot])
        handle = int(scene.materials[shape_id])
        tag = handle >> MATERIAL_TAG_SHIFT

        dist = F(np.linalg.norm(p - o))
        throughput = (throughput * np.exp(-extinction * dist)).astype(np.float32)

        if tag == TAG_EMISSIVE and was_discrete:
            midx = handle & ((1 << MATERIAL_TAG_SHIFT) - 1)
            total = total + throughput * np.asarray(scene.emissive_power[midx], np.float32)

        if tag in (TAG_DIFFUSE, TAG_DIFFUSECBOARD):
            importance, shadow = _sample_emitter(scene, r, p)
            if F(np.linalg.norm(importance)) > M_EPS and F(np.dot(shadow["d"], n)) > 0:
                occ = _intersect_scene(
                    shadow["o"], shadow["d"], shadow["tmin"], shadow["tmax"], scene
                )
                if occ is None:
                    total = total + throughput * _eval_bsdf(
                        scene, handle, shadow["d"], n, uv
                    ) * importance

        wo, weight, extinction = _sample_bsdf(
            scene, handle, d, n, uv, frame_t, frame_b, r, extinction
        )
        throughput = (throughput * weight).astype(np.float32)
        d = wo
        o = p
        tmin, tmax = F(2.0) * M_EPS, F(np.inf)
        was_discrete = tag not in (TAG_DIFFUSE, TAG_DIFFUSECBOARD)

        if bounce > 3:
            q = F(min(F(0.99), float(np.max(throughput))))
            if r.uniform() > q:
                break
            throughput = (throughput / q).astype(np.float32)

    return dict(
        total=total, normal=normal, depth=depth, state=np.uint32(r.state), draws=r.draws
    )
