"""Host-side scene model: materials, shapes, camera, scene container.

Mirrors the reference's scene types (``src/main.rs:34-170``) with plain Python
dataclasses + numpy. Material tag values follow the reference's strum
discriminant order (``src/main.rs:37-44``): Diffuse=0, DiffuseCBoard=1,
Mirror=2, Dielectric=3, Emissive=4; packed material handles are
``(tag << 24) | per_type_index`` (``src/main.rs:45,275``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Tuple, Union

import numpy as np

from hijiki_tpu_torch.utils.quaternion import quaternion_from_axis_angle_x

MATERIAL_TAG_SHIFT = 24
TAG_DIFFUSE = 0
TAG_DIFFUSECBOARD = 1
TAG_MIRROR = 2
TAG_DIELECTRIC = 3
TAG_EMISSIVE = 4

NUM_MATERIAL_TAGS = 5


@dataclass
class Diffuse:
    color: Tuple[float, float, float]
    tag = TAG_DIFFUSE


@dataclass
class DiffuseCheckerboard:
    """Procedural checkerboard-textured diffuse (``materials/diffusecb.glsl``)."""

    color1: Tuple[float, float, float]
    scale_u: float
    color2: Tuple[float, float, float]
    scale_v: float
    tag = TAG_DIFFUSECBOARD


@dataclass
class Mirror:
    tag = TAG_MIRROR


@dataclass
class Dielectric:
    """Smooth dielectric with Beer-Lambert extinction (``src/main.rs:122-139``)."""

    extinction: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    eta_ratio: float = 1.5
    tag = TAG_DIELECTRIC

    @staticmethod
    def clear(eta_ratio: float) -> "Dielectric":
        return Dielectric((0.0, 0.0, 0.0), eta_ratio)

    @staticmethod
    def tinted(extinction, eta_ratio: float) -> "Dielectric":
        return Dielectric(tuple(extinction), eta_ratio)


@dataclass
class Emissive:
    power: Tuple[float, float, float]
    tag = TAG_EMISSIVE


Material = Union[Diffuse, DiffuseCheckerboard, Mirror, Dielectric, Emissive]


@dataclass
class Sphere:
    position: Tuple[float, float, float]
    radius: float


@dataclass
class Quad:
    """Parallelogram: origin + u*edge1 + v*edge2, u,v in [0,1] (``src/shape.rs:22-54``)."""

    origin: Tuple[float, float, float]
    edge1: Tuple[float, float, float]
    edge2: Tuple[float, float, float]


@dataclass
class Triangle:
    """Indexed triangle: three indices into Scene vertex arrays (``src/main.rs:51``)."""

    indices: Tuple[int, int, int]


Shape = Union[Sphere, Quad, Triangle]


@dataclass
class Camera:
    """Pinhole camera: position + rotation quaternion (x,y,z,w) + horizontal fov
    in degrees (``src/main.rs:154-160``, ray model ``shader/render.glsl:26-36``)."""

    position: np.ndarray
    rotation: np.ndarray
    fov: float

    @staticmethod
    def cbox_default() -> "Camera":
        """The reference's hardcoded cbox camera (``src/main.rs:417-425``)."""
        return Camera(
            position=np.array([0.0, 0.91, 5.41], dtype=np.float32),
            rotation=quaternion_from_axis_angle_x(np.radians(np.float32(-1.45))),
            fov=27.7,
        )


@dataclass
class Scene:
    """Scene container: camera, (shape, material index) pairs, shared vertex pool.

    Vertex pool is SoA: positions (V,3) f32, normals (V,3) f32, uvs (V,2) f32 —
    the interleaved ``Vertex {pos,u,normal,v}`` of ``src/main.rs:54-60`` split
    into arrays.
    """

    camera: Camera = field(default_factory=Camera.cbox_default)
    objects: List[Tuple[Shape, int]] = field(default_factory=list)
    materials: List[Material] = field(default_factory=list)
    positions: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3), dtype=np.float32)
    )
    normals: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3), dtype=np.float32)
    )
    uvs: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), dtype=np.float32))
    # Bulk triangle soup (native loaders / generators): equivalent to
    # appending one Triangle object per row AFTER every listed Triangle, but
    # without per-shape Python objects — the compiler consumes these arrays
    # directly (large scenes: millions of Python objects would dominate).
    bulk_tris: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3), dtype=np.int32)
    )
    bulk_tri_mats: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), dtype=np.int32)
    )

    def add_material(self, mat: Material) -> int:
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_object(self, shape: Shape, material_idx: int) -> None:
        self.objects.append((shape, material_idx))

    def triangles(self) -> Tuple[np.ndarray, np.ndarray]:
        """All triangles in global order — listed Triangle objects first,
        then bulk — as ((T,3) i32 indices, (T,) i32 material indices)."""
        listed = [
            (s.indices, m) for s, m in self.objects if isinstance(s, Triangle)
        ]
        tri = np.array([t for t, _ in listed], np.int32).reshape(-1, 3)
        mat = np.array([m for _, m in listed], np.int32)
        return (
            np.concatenate([tri, self.bulk_tris]),
            np.concatenate([mat, self.bulk_tri_mats]),
        )

    def add_triangles_bulk(self, tris: np.ndarray, material_idx: np.ndarray) -> None:
        """Append a (T,3) index array of triangles with per-triangle material
        indices, without creating per-triangle Python objects."""
        tris = np.ascontiguousarray(tris, dtype=np.int32).reshape(-1, 3)
        mats = np.ascontiguousarray(material_idx, dtype=np.int32).reshape(-1)
        if mats.shape[0] != tris.shape[0]:
            raise ValueError("material index count must match triangle count")
        self.bulk_tris = np.concatenate([self.bulk_tris, tris])
        self.bulk_tri_mats = np.concatenate([self.bulk_tri_mats, mats])

    def put_cbox_spheres(self) -> None:
        """Inject the reference's hardcoded mirror + checkerboard spheres
        (``--put-cbox-spheres``, constants from ``src/main.rs:1463-1483``)."""
        mirror_idx = self.add_material(Mirror())
        cboard_idx = self.add_material(
            DiffuseCheckerboard(
                color1=(1.0, 0.4, 0.7), scale_u=0.1, color2=(0.4, 0.7, 1.0), scale_v=0.2
            )
        )
        self.add_object(Sphere((-0.421400, 0.332100, -0.280000), 0.3263), mirror_idx)
        self.add_object(Sphere((0.445800, 0.332100, 0.376700), 0.3263), cboard_idx)

    def put_dielectric_sphere(self, eta: float = 1.5) -> None:
        """Add a clear glass sphere at the reference's second sphere position —
        the dielectric variant the reference keeps commented out
        (``src/main.rs:1466,1476``); used by the full-material-set benchmark
        config."""
        glass_idx = self.add_material(Dielectric.clear(eta))
        self.add_object(Sphere((0.445800, 0.332100, 0.376700), 0.3263), glass_idx)


def material_handle(mat_tag: int, per_type_index: int) -> int:
    """Pack a material handle u32: (tag << 24) | index (``src/main.rs:275``)."""
    return (mat_tag << MATERIAL_TAG_SHIFT) | per_type_index
