"""The benchmark's scene input: the raw scene that both the program and the
plain reference receive.

A configuration file (``configs/<name>.json``) names an OBJ file, the
spheres put into it and the camera. This module parses the OBJ with the upstream CLI's conventions
(mad-s/hijiki ``Scene::from_obj``, ``src/main.rs:414-531``):

* MTL materials by name prefix: ``light*`` emissive with power ``Ke``,
  ``glass*`` a clear dielectric of eta 1.5, ``mirror*`` a mirror, anything
  else diffuse with ``Kd``; materials in MTL declaration order;
* faces fan-triangulated, faces before any ``usemtl`` skipped;
* vertices deduplicated per (v, vt, vn) triple within an ``o``/``g`` model,
  uv (0, 0) where a face has no texcoord; a face without normals is
  refused, as upstream refuses it.

Nothing here imports the program: the harness builds the program's
``Scene`` from a ``RawScene``, and the reference reads the same arrays.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

MATERIAL_TYPES = ("diffuse", "checkerboard", "mirror", "dielectric", "emissive")


@dataclass
class RawScene:
    positions: np.ndarray  # (V, 3) f32
    normals: np.ndarray  # (V, 3) f32
    uvs: np.ndarray  # (V, 2) f32
    tris: np.ndarray  # (T, 3) i32 vertex indices
    tri_mat: np.ndarray  # (T,) i32 material indices
    # dicts: {"type": one of MATERIAL_TYPES, and its parameters}
    materials: list = field(default_factory=list)
    # (center (3,) f32, radius f32, material index)
    spheres: list = field(default_factory=list)
    cam_position: np.ndarray = None  # (3,) f32
    cam_rotation: np.ndarray = None  # (4,) f32 quaternion (x, y, z, w)
    cam_fov: float = 0.0  # horizontal, degrees


def _mtl(path: str) -> list:
    out, cur = [], None
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "newmtl":
                cur = {"name": parts[1] if len(parts) > 1 else "", "kd": (0.0, 0.0, 0.0), "ke": None}
                out.append(cur)
            elif cur is not None and parts[0] in ("Kd", "Ke"):
                cur[parts[0].lower()] = tuple(float(x) for x in parts[1:4])
    return out


def _material(m: dict) -> dict:
    name = m["name"]
    if name.startswith("light"):
        if m["ke"] is None:
            raise ValueError(f"emissive material {name!r} has no Ke")
        return {"type": "emissive", "power": list(m["ke"])}
    if name.startswith("glass"):
        return {"type": "dielectric", "extinction": [0.0, 0.0, 0.0], "eta": 1.5}
    if name.startswith("mirror"):
        return {"type": "mirror"}
    return {"type": "diffuse", "color": list(m["kd"])}


def parse_obj(path: str) -> RawScene:
    """The triangles, vertex pool and materials of an OBJ file."""
    vs, vns, vts = [], [], []
    pos, nrm, uv = [], [], []
    tris, tri_mat = [], []
    mtl_index, mtl_order = {}, []
    cache: dict = {}
    current = None

    def index(tok: str, n: int) -> int:
        i = int(tok)
        r = i - 1 if i > 0 else n + i
        if not 0 <= r < n:
            raise ValueError(f"OBJ index {tok} out of range (have {n})")
        return r

    def vertex(tok: str) -> int:
        f = tok.split("/")
        if len(f) < 3 or f[2] == "":
            raise ValueError(f"OBJ face vertex {tok!r} has no normal (upstream requires one)")
        key = (index(f[0], len(vs)), index(f[1], len(vts)) if f[1] else -1, index(f[2], len(vns)))
        if key not in cache:
            cache[key] = len(pos)
            pos.append(vs[key[0]])
            uv.append(vts[key[1]] if key[1] >= 0 else (0.0, 0.0))
            nrm.append(vns[key[2]])
        return cache[key]

    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                vs.append(tuple(float(x) for x in parts[1:4]))
            elif key == "vn":
                vns.append(tuple(float(x) for x in parts[1:4]))
            elif key == "vt":
                vts.append(tuple(float(x) for x in parts[1:3]))
            elif key in ("o", "g"):
                cache.clear()
            elif key == "mtllib":
                for m in _mtl(os.path.join(os.path.dirname(path), parts[1])):
                    if m["name"] not in mtl_index:
                        mtl_index[m["name"]] = len(mtl_order)
                        mtl_order.append(m)
            elif key == "usemtl":
                current = mtl_index.get(parts[1])
            elif key == "f" and current is not None:
                idx = [vertex(t) for t in parts[1:]]
                for k in range(1, len(idx) - 1):
                    tris.append((idx[0], idx[k], idx[k + 1]))
                    tri_mat.append(current)
    return RawScene(
        positions=np.asarray(pos, np.float32).reshape(-1, 3),
        normals=np.asarray(nrm, np.float32).reshape(-1, 3),
        uvs=np.asarray(uv, np.float32).reshape(-1, 2),
        tris=np.asarray(tris, np.int32).reshape(-1, 3),
        tri_mat=np.asarray(tri_mat, np.int32),
        materials=[_material(m) for m in mtl_order],
    )


def check_material(m: dict) -> dict:
    if m.get("type") not in MATERIAL_TYPES:
        raise ValueError(f"unknown material {m!r} (one of {', '.join(MATERIAL_TYPES)})")
    return m


def load_scene(config: dict, root: str) -> RawScene:
    """The raw scene of a configuration file: its OBJ (a path relative to
    ``root``) with its spheres (their materials appended after the OBJ's)
    and its camera."""
    raw = parse_obj(os.path.join(root, config["obj"]))
    for s in config.get("spheres", ()):
        raw.materials.append(check_material(dict(s["material"])))
        raw.spheres.append((np.asarray(s["center"], np.float32), np.float32(s["radius"]),
                            len(raw.materials) - 1))
    cam = config["camera"]
    # a tilt about +x, as upstream's cbox camera (src/main.rs:417-425):
    # the quaternion of the f32 angle in radians
    half = 0.5 * np.radians(np.float32(cam["tilt_x_deg"]))
    raw.cam_position = np.asarray(cam["position"], np.float32)
    raw.cam_rotation = np.array([np.sin(half), 0.0, 0.0, np.cos(half)], np.float32)
    raw.cam_fov = float(cam["fov_deg"])
    return raw
