"""BSDF evaluation and sampling — masked, branchless, all materials at once.

Port of ``hijiki_tpu/ops/bsdf.py`` (the reference's
``shader/material.glsl:18-91``): every lane computes every material branch
and selects by tag. RNG consumption is predicated to match the reference's
divergent stream exactly: cosine-hemisphere draws only for
diffuse/checkerboard lanes, the Fresnel coin only for dielectric lanes
without total internal reflection.

Reference quirks kept on purpose: the dielectric's inverted inside flag
(``material.glsl:55-84``) and its double reciprocal ``fl(1/fl(1/eta))`` on
inside hits, extinction never reset by other materials, and an emissive
``wo`` defined as ``wi`` (zero weight).

RNG states are int64 tensors holding u32 values (``ops/rng.py``).
"""

from __future__ import annotations

import torch

from hijiki_tpu_torch.ops import rng
from hijiki_tpu_torch.ops.intersect import M_PI, Its, div_const, dot
from hijiki_tpu_torch.scene.model import (
    MATERIAL_TAG_SHIFT,
    TAG_DIELECTRIC,
    TAG_DIFFUSE,
    TAG_DIFFUSECBOARD,
    TAG_EMISSIVE,
    TAG_MIRROR,
)

_IDX_MASK = (1 << MATERIAL_TAG_SHIFT) - 1
_UNROLL_LIMIT = 16


def split_handle(handle):
    """(tag, index) from a packed u32 material handle (``src/main.rs:275``)."""
    handle = handle.long()
    return handle >> MATERIAL_TAG_SHIFT, handle & _IDX_MASK


def select_row(table, idx):
    """``table[idx]`` as the JAX package computes it: for tables of at most
    16 rows a where-chain (an index past the table reads row 0), else a
    gather with the index clamped to the last row."""
    k = table.shape[0]
    if k <= _UNROLL_LIMIT:
        out = table[0].expand(idx.shape + table.shape[1:])
        for row in range(1, k):
            out = torch.where((idx == row)[..., None], table[row], out)
        return out
    return table[torch.clamp(idx.long(), 0, k - 1)]


def checkerboard_texture(color1, color2, scale, uv):
    """Procedural checkerboard (``materials/diffusecb.glsl:6-13``)."""
    st = 0.5 * uv / scale
    st = st - torch.floor(st)  # fract
    flip = (st[..., 0] < 0.5) ^ (st[..., 1] < 0.5)
    return torch.where(flip[..., None], color2, color1)


def _reflect(i, n):
    """GLSL reflect: i - 2*dot(n,i)*n."""
    return i - 2.0 * dot(n, i)[..., None] * n


def _cb_color(scene, idx, uv):
    return checkerboard_texture(
        select_row(scene.cb_color1, idx),
        select_row(scene.cb_color2, idx),
        select_row(scene.cb_scale, idx),
        uv,
    )


def eval_bsdf(scene, tag, idx, wi, its: Its):
    """``evalBSDF`` (``shader/material.glsl:18-30``): nonzero only for
    diffuse/checkerboard; value = dot(n, wi) * albedo / pi."""
    cos_term = dot(its.n, wi)[..., None]
    val_dif = div_const(cos_term * select_row(scene.diffuse_color, idx), M_PI)
    val_cb = div_const(cos_term * _cb_color(scene, idx, its.uv), M_PI)
    return torch.where(
        (tag == TAG_DIFFUSE)[..., None],
        val_dif,
        torch.where((tag == TAG_DIFFUSECBOARD)[..., None], val_cb, 0.0),
    )


def base_color(scene, tag, idx, its: Its):
    """First-hit reflectance for the fixed-albedo AOV: the diffuse color or
    the checkerboard texel at the hit UV; zero for specular and emissive
    surfaces (the reference declares the AOV but never assigns it)."""
    return torch.where(
        (tag == TAG_DIFFUSE)[..., None],
        select_row(scene.diffuse_color, idx),
        torch.where((tag == TAG_DIFFUSECBOARD)[..., None], _cb_color(scene, idx, its.uv), 0.0),
    )


def sample_bsdf(scene, tag, idx, wi, its: Its, state, extinction, active):
    """``sampleBSDF`` (``shader/material.glsl:33-91``), masked over all tags.

    wi: (N,3) incident direction (into the surface); state: (N,) RNG state,
    advanced only where the reference consumes; extinction: (N,3) current
    Beer-Lambert extinction (inout); active: (N,) lanes that shade.
    Returns (state, wo, weight, extinction).
    """
    n = its.n
    # two speculative draws off the current state, committed per tag below
    state1, u1 = rng.rand_uniform_float(state)
    state2, u2 = rng.rand_uniform_float(state1)

    # diffuse / checkerboard: cosine hemisphere in the shading frame
    r = torch.sqrt(u1)
    theta = (2.0 * M_PI) * u2
    lx = r * torch.cos(theta)
    ly = r * torch.sin(theta)
    lz = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    wo_diffuse = its.frame_t * lx[..., None] + its.frame_b * ly[..., None] + n * lz[..., None]
    w_dif = select_row(scene.diffuse_color, idx)
    w_cb = _cb_color(scene, idx, its.uv)

    wo_mirror = _reflect(wi, n)

    # dielectric (material.glsl:50-87, quirks and all)
    ext_eta = select_row(scene.dielectric_ext_eta, idx)
    eta0 = ext_eta[..., 3]
    eta_inv0 = 1.0 / eta0
    cos_i0 = -dot(n, wi)
    inside0 = cos_i0 > 0.0
    flip = cos_i0 < 0.0
    eta = torch.where(flip, eta_inv0, eta0)
    # inside hits: the reference's double reciprocal fl(1/fl(1/eta))
    eta_inv = torch.where(flip, 1.0 / eta_inv0, eta_inv0)
    normal = torch.where(flip[..., None], -n, n)
    cos_i = torch.where(flip, -cos_i0, cos_i0)
    k = 1.0 - eta_inv * eta_inv * (1.0 - cos_i * cos_i)
    tir = k <= 0.0
    cos_o = torch.sqrt(torch.clamp_min(k, 0.0))
    rho_par = (eta * cos_i - cos_o) / (eta * cos_i + cos_o)
    rho_orth = (cos_i - eta * cos_o) / (cos_i + eta * cos_o)
    f_r = 0.5 * (rho_par * rho_par + rho_orth * rho_orth)
    # the Fresnel coin is the first speculative draw (consumed only if !tir)
    choose_reflect = u1 < f_r
    refl = _reflect(wi, normal)
    parallel = wi - dot(wi, normal)[..., None] * normal
    refr = eta_inv[..., None] * parallel - cos_o[..., None] * normal
    wo_diel = torch.where((tir | choose_reflect)[..., None], refl, refr)
    refracted = ~tir & ~choose_reflect
    inside_final = torch.where(refracted, ~inside0, inside0)
    ext_diel = torch.where(inside_final[..., None], ext_eta[..., :3], extinction)

    is_dif = tag == TAG_DIFFUSE
    is_cb = tag == TAG_DIFFUSECBOARD
    is_mir = tag == TAG_MIRROR
    is_diel = tag == TAG_DIELECTRIC
    is_em = tag == TAG_EMISSIVE

    wo = torch.where(
        (is_dif | is_cb)[..., None],
        wo_diffuse,
        torch.where(is_mir[..., None], wo_mirror, torch.where(is_diel[..., None], wo_diel, wi)),
    )
    weight = torch.where(
        is_dif[..., None],
        w_dif,
        torch.where(is_cb[..., None], w_cb, torch.where((is_mir | is_diel)[..., None], 1.0, 0.0)),
    )
    weight = torch.where(is_em[..., None], 0.0, weight)
    new_ext = torch.where((is_diel & active)[..., None], ext_diel, extinction)

    # RNG commit: diffuse-ish lanes consumed two draws, dielectric (no TIR) one
    consumed2 = active & (is_dif | is_cb)
    consumed1 = active & is_diel & ~tir
    new_state = torch.where(consumed2, state2, torch.where(consumed1, state1, state))
    return new_state, wo, weight, new_ext
