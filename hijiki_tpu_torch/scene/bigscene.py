"""A large triangle scene from a small one: the 4-to-1 edge-midpoint split.

The split of ``tools/make_bigscene.py`` (which rewrites an OBJ file),
applied to a loaded ``Scene`` in memory: each triangle becomes four at its
edge midpoints, the midpoint vertex's position, normal and uv interpolated
linearly between the edge's two vertices (one midpoint per shared edge, so
the mesh stays watertight), each new triangle keeping its parent's
material. The geometry is the same surface, only denser, so the image is
the same scene's while the trace table grows past the size at which
``compile_scene(packed_leaf="auto")`` packs its rows. Spheres and quads
are kept as they are.

Two levels on ``scenes/meshbox/meshbox.obj`` (6,274 triangles) with the
cbox spheres give 100,384 triangles.
"""

from __future__ import annotations

import numpy as np

from hijiki_tpu_torch.scene.model import Scene, Triangle


def _split_once(pos, nrm, uv, tris):
    """One 4-to-1 split of ``tris`` (T, 3) over the vertex pool; returns the
    grown pool and the (4T, 3) triangles (for triangle k: 4k corner v0, 4k+1
    corner v1, 4k+2 corner v2, 4k+3 the middle one)."""
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    edges = np.stack([np.stack([v0, v1], 1), np.stack([v1, v2], 1),
                      np.stack([v2, v0], 1)], 1).reshape(-1, 2)
    key = np.sort(edges, axis=1)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    a, b = uniq[:, 0], uniq[:, 1]
    half = np.float32(0.5)
    base = pos.shape[0]
    pos = np.concatenate([pos, (pos[a] + pos[b]) * half])
    nrm = np.concatenate([nrm, (nrm[a] + nrm[b]) * half])
    uv = np.concatenate([uv, (uv[a] + uv[b]) * half])
    mid = (base + inv.reshape(-1)).reshape(-1, 3)  # m01, m12, m20 a triangle
    m01, m12, m20 = mid[:, 0], mid[:, 1], mid[:, 2]
    out = np.stack([
        np.stack([v0, m01, m20], 1),
        np.stack([m01, v1, m12], 1),
        np.stack([m20, m12, v2], 1),
        np.stack([m01, m12, m20], 1),
    ], 1).reshape(-1, 3)
    return pos, nrm, uv, out.astype(np.int32)


def split_scene(scene: Scene, levels: int = 2) -> Scene:
    """``scene`` with every triangle split 4-to-1 ``levels`` times (4**levels
    triangles for each), as bulk triangles after its spheres and quads."""
    tris, mats = scene.triangles()
    pos = np.asarray(scene.positions, np.float32).reshape(-1, 3)
    nrm = np.asarray(scene.normals, np.float32).reshape(-1, 3)
    uv = np.asarray(scene.uvs, np.float32).reshape(-1, 2)
    for _ in range(levels):
        pos, nrm, uv, tris = _split_once(pos, nrm, uv, tris)
        mats = np.repeat(mats, 4)
    out = Scene(camera=scene.camera, materials=list(scene.materials),
                objects=[(s, m) for s, m in scene.objects if not isinstance(s, Triangle)],
                positions=pos, normals=nrm, uvs=uv)
    out.add_triangles_bulk(tris, mats)
    return out
