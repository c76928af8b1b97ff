"""OBJ/MTL loader with the reference's material conventions.

Reimplements ``Scene::from_obj`` (``src/main.rs:414-531``) without tobj:

* MTL materials are dispatched by **name prefix**: ``light*`` -> Emissive with
  power from the nonstandard ``Ke`` key, ``glass*`` -> Dielectric(eta=1.5),
  ``mirror*`` -> Mirror, everything else -> Diffuse(Kd)
  (``src/main.rs:432-458``).
* Faces are fan-triangulated (0,1,2),(0,2,3),... — matching tobj's behaviour
  (the reference's dead quad-recovery code at ``src/main.rs:489-526`` assumes
  exactly this fan order).
* Vertices are deduplicated per distinct (v, vt, vn) triple per model, with
  (0,0) UV fallback when a face has no texcoord (``src/main.rs:465-474``).
* The cbox camera is hardcoded exactly as in the reference
  (``src/main.rs:417-425``).
* Faces appearing before any ``usemtl`` are skipped, mirroring the reference's
  ``material_id: None => continue`` (``src/main.rs:479-482``).

One deliberate extension beyond the reference: the reference *requires*
per-vertex normals (``src/main.rs:468`` unwraps the normal index) and panics
on OBJs without them. Here faces lacking ``vn`` get generated normals —
area-weighted vertex normals within a smoothing group (``s N``), flat face
normals when smoothing is off (``s off``/``s 0``, the OBJ default). Files
with normals behave exactly as the reference.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from hijiki_tpu_torch.scene.model import (
    Camera,
    Dielectric,
    Diffuse,
    Emissive,
    Mirror,
    Scene,
    Triangle,
)


class MtlMaterial:
    def __init__(self, name: str):
        self.name = name
        self.kd = (0.0, 0.0, 0.0)
        self.ke: Optional[Tuple[float, float, float]] = None


def parse_mtl(path: str) -> List[MtlMaterial]:
    materials: List[MtlMaterial] = []
    cur: Optional[MtlMaterial] = None
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = MtlMaterial(parts[1] if len(parts) > 1 else "")
                materials.append(cur)
            elif cur is None:
                continue
            elif key == "Kd":
                cur.kd = (float(parts[1]), float(parts[2]), float(parts[3]))
            elif key == "Ke":
                cur.ke = (float(parts[1]), float(parts[2]), float(parts[3]))
    return materials


def _dispatch_material(m: MtlMaterial):
    """Name-prefix material dispatch (``src/main.rs:432-458``)."""
    if m.name.startswith("light"):
        if m.ke is None:
            raise ValueError(
                f"emissive material {m.name!r} is missing the 'Ke' key "
                "(required, as in the reference src/main.rs:433-437)"
            )
        return Emissive(m.ke)
    if m.name.startswith("glass"):
        return Dielectric.clear(1.5)
    if m.name.startswith("mirror"):
        return Mirror()
    return Diffuse(m.kd)


def load_obj_scene(path: str, backend: str = "python") -> Scene:
    """Parse an OBJ (+MTL) file into a Scene, reference-conformant.

    Only the pure-Python parser is ported (``hijiki_tpu``'s
    ``backend="python"``); the native C++ parser is still to port.
    """
    if backend != "python":
        raise NotImplementedError(
            f"OBJ backend {backend!r} is not ported yet; use 'python'"
        )
    return _load_obj_scene_python(path)


def _load_obj_scene_python(path: str) -> Scene:
    """The pure-Python reference parser."""
    positions_raw: List[Tuple[float, float, float]] = []
    normals_raw: List[Tuple[float, float, float]] = []
    uvs_raw: List[Tuple[float, float]] = []

    scene = Scene(camera=Camera.cbox_default())

    mtl_order: List[MtlMaterial] = []
    mtl_index: Dict[str, int] = {}

    out_positions: List[Tuple[float, float, float]] = []
    out_normals: List[Tuple[float, float, float]] = []
    out_uvs: List[Tuple[float, float]] = []

    # Per-model dedup of (v, vt, vn[, smoothing group]) triples; a new
    # 'o'/'g' starts a new model.
    triple_cache: Dict[Tuple[int, int, int, int], int] = {}
    current_material: Optional[int] = None
    smoothing_group = 0  # OBJ default: smoothing off
    # out-vertex indices whose normal must be generated (accumulated
    # area-weighted face normals, normalized at the end)
    gen_normal: List[int] = []
    gen_faces: List[Tuple[int, int, int]] = []

    def new_model():
        triple_cache.clear()

    def resolve_index(token: str, arr_len: int) -> int:
        i = int(token)
        r = i - 1 if i > 0 else arr_len + i
        if r < 0 or r >= arr_len:
            # Python list indexing would silently wrap a doubly-negative
            # index (arr_len + i in [-arr_len, -1]) to a WRONG vertex —
            # malformed OBJs must fail loudly, not corrupt geometry
            raise ValueError(f"OBJ index {token} out of range (have {arr_len})")
        return r

    def vertex_for(token: str) -> int:
        vs = token.split("/")
        vi = resolve_index(vs[0], len(positions_raw))
        ti = (
            resolve_index(vs[1], len(uvs_raw))
            if len(vs) > 1 and vs[1] != ""
            else -1
        )
        ni = (
            resolve_index(vs[2], len(normals_raw))
            if len(vs) > 2 and vs[2] != ""
            else -1
        )
        # generated normals are shared only within a smoothing group; with
        # smoothing off every face gets fresh vertices (flat shading)
        key = (vi, ti, ni, smoothing_group if ni < 0 else -1)
        if ni >= 0 or smoothing_group:
            if key in triple_cache:
                return triple_cache[key]
        idx = len(out_positions)
        out_positions.append(positions_raw[vi])
        out_uvs.append(uvs_raw[ti] if ti >= 0 else (0.0, 0.0))
        if ni < 0:
            out_normals.append((0.0, 0.0, 0.0))
            gen_normal.append(idx)
        else:
            out_normals.append(normals_raw[ni])
        triple_cache[key] = idx
        return idx

    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                positions_raw.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif key == "vn":
                normals_raw.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif key == "vt":
                uvs_raw.append((float(parts[1]), float(parts[2])))
            elif key in ("o", "g"):
                new_model()
            elif key == "mtllib":
                mtl_path = os.path.join(os.path.dirname(path), parts[1])
                for m in parse_mtl(mtl_path):
                    if m.name not in mtl_index:
                        mtl_index[m.name] = len(mtl_order)
                        mtl_order.append(m)
            elif key == "usemtl":
                current_material = mtl_index.get(parts[1])
            elif key == "s":
                tok = parts[1] if len(parts) > 1 else "off"
                smoothing_group = 0 if tok in ("off", "0") else int(tok)
            elif key == "f":
                if current_material is None:
                    continue
                idxs = [vertex_for(tok) for tok in parts[1:]]
                has_gen = any("/" not in t or t.split("/")[2:3] in ([], [""])
                              for t in parts[1:])
                for k in range(1, len(idxs) - 1):  # fan triangulation
                    tri = (idxs[0], idxs[k], idxs[k + 1])
                    scene.add_object(Triangle(tri), current_material)
                    if has_gen:
                        gen_faces.append(tri)

    # Materials enter the scene in MTL declaration order, like the reference's
    # iteration over tobj's material list (src/main.rs:431-458).
    for m in mtl_order:
        scene.add_material(_dispatch_material(m))

    scene.positions = np.asarray(out_positions, dtype=np.float32).reshape(-1, 3)
    scene.normals = np.asarray(out_normals, dtype=np.float32).reshape(-1, 3)
    scene.uvs = np.asarray(out_uvs, dtype=np.float32).reshape(-1, 2)

    if gen_normal:
        # area-weighted accumulation: the unnormalized cross product is twice
        # the face area times the unit normal, so summing it per vertex and
        # normalizing yields area-weighted smooth normals; flat-shaded faces
        # have unshared vertices, so they end up with the plain face normal
        need = np.zeros(len(out_positions), dtype=bool)
        need[gen_normal] = True
        p = scene.positions
        acc = np.zeros_like(scene.normals)
        for ia, ib, ic in gen_faces:
            fn = np.cross(p[ib] - p[ia], p[ic] - p[ia])
            for iv in (ia, ib, ic):
                if need[iv]:
                    acc[iv] += fn
        norms = np.linalg.norm(acc, axis=1, keepdims=True)
        acc = np.divide(acc, norms, out=np.zeros_like(acc), where=norms > 0)
        scene.normals[need] = acc[need]
    return scene
