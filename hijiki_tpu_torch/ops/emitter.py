"""Next-event estimation: emitter selection + area sampling.

Port of ``hijiki_tpu/ops/emitter.py`` (the reference's ``sampleEmitter``,
``shader/scene.glsl:54-89``, and ``sampleShape``, ``scene.glsl:44-52``, with
the per-shape samplers of ``shader/shapes/*.glsl``). Three RNG draws per
active lane: the emitter pick and two shape-sample draws.

Emitter pick: the first i with u < cdf[i], emitter 0 when there is none
(the reference's fallback when its running value never goes negative).
Up to 8 emitters are sampled by evaluating every (statically known)
emitter and selecting by the pick; more go through gathers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hijiki_tpu_torch.ops import rng
from hijiki_tpu_torch.ops.bsdf import select_row, split_handle
from hijiki_tpu_torch.ops.intersect import M_EPS, M_PI, cross, dot, gather, norm
from hijiki_tpu_torch.scene.compile import KIND_QUAD, KIND_SPHERE


class EmitterSample(NamedTuple):
    importance: torch.Tensor  # (N,3) power/pdf, zero if backfacing
    shadow_o: torch.Tensor  # (N,3)
    shadow_d: torch.Tensor  # (N,3)
    shadow_tmin: torch.Tensor  # (N,)
    shadow_tmax: torch.Tensor  # (N,)


_UNROLL_EMITTERS = 8


def _sphere_sample(sp, u1, u2):
    """Uniform area sample of spheres ``sp`` (..., 4) (sphere.glsl:54-62)."""
    z = 2.0 * u1 - 1.0
    theta = (2.0 * M_PI) * u2
    rr = torch.sqrt(1.0 - z * z)
    n = torch.stack([rr * torch.cos(theta), rr * torch.sin(theta), z], dim=-1)
    p = sp[..., :3] + sp[..., 3:4] * n
    pdf = 1.0 / (sp[..., 3] * sp[..., 3] * 4.0 * M_PI)
    return p, n, pdf


def _tri_sample(pa, pb, pc, na, nb, nc, u1, u2):
    """Triangle area sample (triangle.glsl:81-102) with the randBarycentric
    fold quirk (rand.glsl:44-47): u = 1 - v when u + v > 1, then v = 1 - u
    reads the new u, so v is unchanged."""
    lu = torch.where(u1 + u2 > 1.0, 1.0 - u2, u1)
    lv = u2
    lw = 1.0 - lu - lv
    area = norm(cross(pb - pa, pc - pa)) / 2.0
    n = na * lu[..., None] + nb * lv[..., None] + nc * lw[..., None]
    n = n / norm(n, keepdim=True)
    p = pa * lu[..., None] + pb * lv[..., None] + pc * lw[..., None]
    return p, n, 1.0 / area


def _sample_shape_static(scene, kind, local, u1, u2):
    """Sample one statically known emitter shape; returns (p, n, pdf)."""
    if kind == KIND_SPHERE:
        p, n, pdf = _sphere_sample(scene.sphere_pos_radius[local], u1, u2)
        return p, n, pdf.expand(u1.shape)
    if kind == KIND_QUAD:  # shader/shapes/quad.glsl:34-45
        qo = scene.quad_origin[local]
        e1 = scene.quad_edge1[local]
        e2 = scene.quad_edge2[local]
        qn = cross(e1, e2)
        area = norm(qn)
        n = (qn / area).expand(u1.shape + (3,))
        p = qo + u1[..., None] * e1 + u2[..., None] * e2
        return p, n, (1.0 / area).expand(u1.shape)
    # one gather by the (3,) index tensor: indexing by its 0-d elements
    # would read each back to the host (a device sync apiece)
    tri = scene.tri_indices[local].long()
    vp = torch.index_select(scene.vtx_positions, 0, tri)
    vn = torch.index_select(scene.vtx_normals, 0, tri)
    p, n, pdf = _tri_sample(vp[0], vp[1], vp[2], vn[0], vn[1], vn[2], u1, u2)
    return p, n, pdf.expand(u1.shape)


def _sample_emitter_unrolled(scene, emitter, u1, u2):
    """Evaluate every emitter and select by the picked index. Returns (p,
    n, pdf_shape, power, em_pdf)."""
    out = None
    for e in range(scene.num_emitters):
        pe, ne, pdfe = _sample_shape_static(
            scene, scene.emitter_kind_static[e], scene.emitter_local_static[e], u1, u2
        )
        pwe = scene.emissive_power[scene.emitter_midx_static[e]].expand(u1.shape + (3,))
        epe = scene.emitter_pdf[e].expand(u1.shape)
        if out is None:
            out = [pe, ne, pdfe, pwe, epe]
            continue
        sel = emitter == e
        out = [torch.where(sel[..., None] if x.dim() > sel.dim() else sel, x, prev)
               for x, prev in zip((pe, ne, pdfe, pwe, epe), out)]
    return out


def _importance(p_s, n_s, pdf_s, power, em_pdf, ref_p):
    """Importance and shadow ray toward the sampled point (scene.glsl:66-88)."""
    dvec = p_s - ref_p
    dist = norm(dvec)
    direction = dvec / dist[..., None]
    cos_theta = -dot(direction, n_s)
    pdf = em_pdf * pdf_s * dist * dist / cos_theta
    importance = torch.where((cos_theta < 0.0)[..., None], 0.0, power / pdf[..., None])
    return EmitterSample(
        importance=importance,
        shadow_o=ref_p,
        shadow_d=direction,
        shadow_tmin=torch.full_like(dist, 2.0 * M_EPS),
        shadow_tmax=dist - M_EPS,
    )


def sample_emitter(scene, state, ref_p, active):
    """Sample a point on an emitter and build the shadow ray toward it.
    Returns (new_state, EmitterSample); the state advances only where
    ``active``."""
    E = scene.num_emitters
    S, Q = scene.num_spheres, scene.num_quads

    state1, u_pick = rng.rand_uniform_float(state)
    state2, u1 = rng.rand_uniform_float(state1)
    state3, u2 = rng.rand_uniform_float(state2)
    new_state = torch.where(active, state3, state)

    # first emitter with u < cdf; none -> 0 (the reference's fallback)
    emitter = torch.argmax((u_pick[..., None] < scene.emitter_cdf[:E]).to(torch.int32), dim=-1)

    if 0 < len(scene.emitter_kind_static) == E <= _UNROLL_EMITTERS:
        return new_state, _importance(*_sample_emitter_unrolled(scene, emitter, u1, u2), ref_p)

    em_pdf = scene.emitter_pdf[emitter]
    shape = scene.emitter_shape[emitter].long()  # global shape index

    # sampleShape dispatch by global index range (scene.glsl:44-52)
    p_sph, n_sph, pdf_sph = _sphere_sample(select_row(scene.sphere_pos_radius, shape), u1, u2)

    qidx = torch.clamp(shape - S, 0, scene.quad_origin.shape[0] - 1)
    qe1, qe2 = scene.quad_edge1[qidx], scene.quad_edge2[qidx]
    qn = cross(qe1, qe2)
    q_area = norm(qn)
    n_quad = qn / q_area[..., None]
    p_quad = scene.quad_origin[qidx] + u1[..., None] * qe1 + u2[..., None] * qe2
    pdf_quad = 1.0 / q_area

    tidx = torch.clamp(shape - S - Q, 0, scene.tri_indices.shape[0] - 1)
    tri = scene.tri_indices[tidx].long()
    vp, vn = scene.vtx_positions, scene.vtx_normals
    t0, t1, t2 = tri[..., 0], tri[..., 1], tri[..., 2]
    p_tri, n_tri, pdf_tri = _tri_sample(vp[t0], vp[t1], vp[t2], vn[t0], vn[t1], vn[t2], u1, u2)

    is_sphere = shape < S
    is_quad = (shape >= S) & (shape < S + Q)
    p_s = torch.where(is_sphere[..., None], p_sph, torch.where(is_quad[..., None], p_quad, p_tri))
    n_s = torch.where(is_sphere[..., None], n_sph, torch.where(is_quad[..., None], n_quad, n_tri))
    pdf_s = torch.where(is_sphere, pdf_sph, torch.where(is_quad, pdf_quad, pdf_tri))

    _, midx = split_handle(gather(scene.materials, shape))
    power = select_row(scene.emissive_power, midx)
    return new_state, _importance(p_s, n_s, pdf_s, power, em_pdf, ref_p)
