"""Bilateral feature-buffer reconstruction filter + progressive accumulation.

Port of ``hijiki_tpu/render/reconstruct.py`` (the reference's
``shader/reconstruction.glsl``) as one vectorized full-image stencil per
sweep. For every output pixel p and window offset delta (|delta| <= R):

* spatial weight = exp(gaussFac * |delta + sampleOffset - 0.5|^2) - curveOffset,
  skipped when negative;
* feature weight = exp(-(2 * |n(q) - n_center|^2 + |a(q) - a_center|^2)),
  q = p + delta;
* the contribution w * (rgb, 1) accumulates into the (rgb*weight, weight)
  film; normalization by .w happens only at save time.

The reference's block-boundary quirks are kept: a sample q splats only to
pixels p inside or right/below its own block (no left/top spill), spill
pixels read zero center features, and NaN contributions are rejected per
(p, delta). With the reference's always-zero albedo AOV this is the plain
twin of the CUDA reconstruction kernel (``render/pallas_reconstruct.py``).
"""

from __future__ import annotations

import numpy as np
import torch


def _sumsq(v):
    """(x*x + y*y) + z*z over the last axis, in that order (as the CUDA
    kernel sums it)."""
    return v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]


def spatial_weights(sample_offset, radius: int = 2, stddev: float = 0.5):
    """The (2R+1)^2 spatial weights exp(gaussFac |delta + so - 0.5|^2) -
    curveOffset as f32 (dy-major); the CUDA kernel computes them with the
    same f32 operations."""
    f32 = torch.float32
    gauss_fac = float(np.float32(-1.0 / (2.0 * stddev * stddev)))
    curve_offset = torch.exp(torch.tensor(gauss_fac * (radius * radius), dtype=f32))
    so = torch.as_tensor(sample_offset, dtype=f32).cpu() - 0.5
    out = []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            off = torch.stack([dx + so[0], dy + so[1]])
            out.append(torch.exp(gauss_fac * torch.sum(off * off)) - curve_offset)
    return torch.stack(out)


def reconstruct_sweep(
    color,  # (H,W,3) per-pixel radiance of this sweep
    normal,  # (H,W,3) first-hit normal AOV
    albedo,  # (H,W,3) albedo AOV (always zero in reference mode)
    sample_offset,  # (2,) f32, this sweep's subpixel jitter
    *,
    block_size: int,
    radius: int = 2,
    stddev: float = 0.5,
    sample_weight=None,  # (H,W) mask of locally rendered pixels, default all 1
):
    """One sweep's reconstruction: returns the (H,W,4) film delta.

    ``sample_weight`` serves multi-device partial films: pixels a device did
    not render (a band canvas' padding) carry weight 0, so their (rgb*w, w)
    contribution vanishes."""
    f32 = torch.float32
    dev = color.device
    H, W = color.shape[0], color.shape[1]
    R, B = radius, block_size

    w_sps = spatial_weights(sample_offset, R, stddev).tolist()

    # the integrator's sample value vec4(total, 1), times the sample weight
    if sample_weight is None:
        w_ch = torch.ones((H, W, 1), dtype=f32, device=dev)
    else:
        w_ch = sample_weight.to(f32)[..., None]
    cw = torch.cat([color * w_ch, w_ch], dim=-1)

    py = torch.arange(H, device=dev).view(-1, 1)
    px = torch.arange(W, device=dev).view(1, -1)

    def pad(img):  # zero-pad by R so shifted reads are plain slices
        return torch.nn.functional.pad(img, (0, 0, R, R, R, R))

    cw_p, n_p, a_p = pad(cw), pad(normal), pad(albedo)

    out = torch.zeros((H, W, 4), dtype=f32, device=dev)
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            w_sp = w_sps[(dy + R) * (2 * R + 1) + (dx + R)]

            qx, qy = px + dx, py + dy
            in_img = (qx >= 0) & (qx < W) & (qy >= 0) & (qy < H)
            ox = torch.div(qx, B, rounding_mode="floor") * B
            oy = torch.div(qy, B, rounding_mode="floor") * B
            dw = torch.clamp_max(W - ox, B)
            dh = torch.clamp_max(H - oy, B)
            lx, ly = px - ox, py - oy
            in_splat = (lx >= 0) & (ly >= 0) & (lx < dw + R) & (ly < dh + R)
            center_valid = ((lx < dw) & (ly < dh))[..., None]
            n_center = torch.where(center_valid, normal, 0.0)
            a_center = torch.where(center_valid, albedo, 0.0)

            sl = lambda img: img[R + dy : R + dy + H, R + dx : R + dx + W]
            cw_q, n_q, a_q = sl(cw_p), sl(n_p), sl(a_p)

            dn = n_q - n_center
            da = a_q - a_center
            w_feat = torch.exp(-(_sumsq(dn) * 2.0 + _sumsq(da)))
            w = w_sp * w_feat
            contrib = w[..., None] * cw_q
            valid = (
                (w_sp >= 0.0)
                & in_img
                & in_splat
                & ~torch.any(torch.isnan(contrib), dim=-1)
            )
            out = out + torch.where(valid[..., None], contrib, 0.0)
    return out


def normalize_film(film):
    """rgb / weight — the preview/save normalization (preview.glsl:11,
    src/main.rs:1399)."""
    return film[..., :3] / film[..., 3:4]
