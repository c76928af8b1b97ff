"""Quaternion helpers mirroring the reference device math.

Reference: ``shader/quaternion.glsl:1-19``. Quaternions are (x, y, z, w)
4-tuples/arrays; vectors are stacked [..., 3] arrays. Works with numpy or jnp.
"""

from __future__ import annotations

import numpy as np


def quaternion_mult(qa, qb, xp):
    """Hamilton product, reference ``shader/quaternion.glsl:1-6``."""
    aw, bw = qa[..., 3], qb[..., 3]
    av, bv = qa[..., :3], qb[..., :3]
    w = aw * bw - xp.sum(av * bv, axis=-1)
    v = xp.cross(av, bv) + av * bw[..., None] + bv * aw[..., None]
    return xp.concatenate([v, w[..., None]], axis=-1)


def quaternion_rotate(v, r, xp):
    """Rotate vector(s) v by quaternion r: (r * (v,0) * conj(r)).xyz.

    Reference ``shader/quaternion.glsl:15-19``.
    """
    zero = xp.zeros_like(v[..., :1])
    v4 = xp.concatenate([v, zero], axis=-1)
    tmp = quaternion_mult(r, v4, xp)
    conj = xp.concatenate([-r[..., :3], r[..., 3:4]], axis=-1)
    return quaternion_mult(tmp, conj, xp)[..., :3]


def quaternion_from_axis_angle_x(angle_rad: float) -> np.ndarray:
    """Rotation about +x by angle (radians), as used for the cbox camera tilt
    (reference ``src/main.rs:417-419``)."""
    half = 0.5 * angle_rad
    return np.array([np.sin(half), 0.0, 0.0, np.cos(half)], dtype=np.float32)
