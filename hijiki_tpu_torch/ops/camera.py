"""Camera ray generation (quaternion pinhole camera).

Port of ``hijiki_tpu/ops/camera.py``; reference ``getCameraRayAt``
(``shader/render.glsl:26-36``): horizontal-FOV pinhole model, the
unnormalized direction (x, -y, -1) rotated by the camera quaternion and then
normalized. tMin = M_EPS, tMax = +inf (the reference's GLSL literal 1e100
overflows to f32 +inf).
"""

from __future__ import annotations

import torch

M_EPS = 1e-4


def _quat_mult(qa, qb):
    """Hamilton product of (..., 4) quaternions (``shader/quaternion.glsl:1-6``)."""
    aw, bw = qa[..., 3], qb[..., 3]
    av, bv = qa[..., :3], qb[..., :3]
    w = aw * bw - torch.sum(av * bv, dim=-1)
    v = torch.linalg.cross(av, bv, dim=-1) + av * bw[..., None] + bv * aw[..., None]
    return torch.cat([v, w[..., None]], dim=-1)


def quaternion_rotate(v, r):
    """Rotate (..., 3) vectors by (..., 4) quaternions:
    (r * (v, 0) * conj(r)).xyz (``shader/quaternion.glsl:15-19``)."""
    v4 = torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
    tmp = _quat_mult(r, v4)
    conj = torch.cat([-r[..., :3], r[..., 3:4]], dim=-1)
    return _quat_mult(tmp, conj)[..., :3]


def camera_rays(cam_position, cam_rotation, cam_fov_deg, pixel_xy, dimension):
    """Generate camera rays.

    Args:
      cam_position: (3,) f32 tensor.
      cam_rotation: (4,) f32 quaternion (x, y, z, w).
      cam_fov_deg: () f32 tensor, horizontal fov in degrees.
      pixel_xy: (..., 2) f32 sample positions in image coords (pixel + jitter).
      dimension: (width, height).

    Returns:
      (origins (..., 3), directions (..., 3), tmin (...,), tmax (...,))
    """
    dev = pixel_xy.device
    f32 = torch.float32
    dim = torch.as_tensor(dimension, dtype=f32, device=dev)
    x = pixel_xy - 0.5 * dim
    fov = torch.as_tensor(cam_fov_deg, dtype=f32, device=dev)
    half_fov = 0.5 * torch.deg2rad(fov)
    x = x * torch.tan(half_fov) / (0.5 * dim[0])
    d_local = torch.stack([x[..., 0], -x[..., 1], -torch.ones_like(x[..., 0])], dim=-1)
    rot = torch.as_tensor(cam_rotation, dtype=f32, device=dev)
    d = quaternion_rotate(d_local, rot.expand(d_local.shape[:-1] + (4,)))
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    o = torch.as_tensor(cam_position, dtype=f32, device=dev).expand(d.shape)
    shape = d.shape[:-1]
    return (
        o,
        d,
        torch.full(shape, M_EPS, dtype=f32, device=dev),
        torch.full(shape, float("inf"), dtype=f32, device=dev),
    )
