"""ctypes bindings for the native C++ scalar oracle (``oracle_native.cpp``).

The source is a copy of ``hijiki_tpu/ops/oracle_native.cpp``, built through
``utils.build.build_host`` (cached under ``build/native/``) with the JAX
package's default flags, ``-O2 -fno-fast-math -ffp-contract=off``: no
fast-math and no contraction keep the f32 expression trees identical to the
numpy oracle (``ops/oracle.py``); the only divergence class is
libm-vs-numpy 1-ulp trig/exp rounding. Unlike the JAX package, no
environment variable appends flags: the oracle is built one way only.

The oracle is the equal-seed gate's reference (BASELINE north star: MSE
against the reference estimator at equal seeds). It walks every primitive
of the scene by brute force, with no BVH, so it shares no trace-row table,
box or cache with the kernels it judges.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).with_name("oracle_native.cpp")
FLAGS = ("-O2", "-fno-fast-math", "-ffp-contract=off")
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def load_library() -> Optional[ctypes.CDLL]:
    """Compile (if needed) and load the native oracle; None if unavailable."""
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    from hijiki_tpu_torch.utils.build import build_host

    try:
        lib = ctypes.CDLL(str(build_host(SRC, FLAGS)))
    except (OSError, RuntimeError):
        _load_failed = True
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    c_i32 = ctypes.c_int32
    lib.hijiki_oracle_render.restype = None
    lib.hijiki_oracle_render.argtypes = [
        f32p, f32p, f32p,            # prim_a/b/c
        i32p, i32p, i32p,            # prim_kind/shape_id/tri
        c_i32, c_i32, c_i32,         # num_prims, kind_sphere, kind_tri
        u32p,                        # materials
        f32p, f32p, f32p,            # vtx pos/nrm/uv
        f32p, f32p, i32p, c_i32,     # emitter cdf/pdf/shape, n
        c_i32, c_i32,                # num_spheres, num_quads
        f32p, f32p, f32p, f32p,      # sphere_pr, quad o/e1/e2
        i32p,                        # tri_indices
        f32p, f32p, f32p, f32p,      # diffuse, cb1, cb2, cb_scale
        f32p, f32p,                  # emissive_power, dielectric
        c_i32, c_i32, c_i32, c_i32, c_i32, c_i32,  # tag consts
        f64p,                        # cam8
        c_i32, c_i32, c_i32,         # W, H, max_bounces
        u32p, f32p, c_i32,           # seeds, offsets, n_sweeps
        f64p,                        # acc
    ]
    _lib = lib
    return lib


def render_oracle_native(
    cs,
    seeds: np.ndarray,    # (n_sweeps, W*H) u32 per-pixel seeds
    offsets: np.ndarray,  # (n_sweeps, 2) f32 sweep jitter
    width: int,
    height: int,
    max_bounces: int = 1000,
    acc: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Accumulate n_sweeps oracle sweeps into (H, W, 3) float64 radiance
    (divide by total sweeps for the mean film). ``cs`` is the port's
    CompiledScene, its fields numpy arrays or tensors (copied to the host
    here; the oracle never touches a device). Raises RuntimeError if the
    native library is unavailable."""
    from hijiki_tpu_torch.ops.oracle import host_scene
    from hijiki_tpu_torch.scene.compile import KIND_SPHERE, KIND_TRIANGLE
    from hijiki_tpu_torch.scene.model import (
        MATERIAL_TAG_SHIFT,
        TAG_DIELECTRIC,
        TAG_DIFFUSE,
        TAG_DIFFUSECBOARD,
        TAG_EMISSIVE,
        TAG_MIRROR,
    )

    lib = load_library()
    if lib is None:
        raise RuntimeError("native oracle unavailable (g++ build failed)")
    cs = host_scene(cs)

    def f32c(x):
        return np.ascontiguousarray(np.asarray(x), np.float32)

    def i32c(x):
        return np.ascontiguousarray(np.asarray(x), np.int32)

    seeds = np.ascontiguousarray(seeds, np.uint32).reshape(-1, width * height)
    offsets = np.ascontiguousarray(offsets, np.float32).reshape(-1, 2)
    n_sweeps = seeds.shape[0]
    assert offsets.shape[0] == n_sweeps
    if acc is None:
        acc = np.zeros((height, width, 3), np.float64)
    assert acc.shape == (height, width, 3) and acc.dtype == np.float64

    lib.hijiki_oracle_render(
        f32c(cs.prim_a), f32c(cs.prim_b), f32c(cs.prim_c),
        i32c(cs.prim_kind), i32c(cs.prim_shape_id), i32c(cs.prim_tri),
        int(cs.num_prims), int(KIND_SPHERE), int(KIND_TRIANGLE),
        np.ascontiguousarray(np.asarray(cs.materials), np.uint32),
        f32c(cs.vtx_positions), f32c(cs.vtx_normals), f32c(cs.vtx_uvs),
        f32c(cs.emitter_cdf), f32c(cs.emitter_pdf), i32c(cs.emitter_shape),
        int(cs.num_emitters), int(cs.num_spheres), int(cs.num_quads),
        f32c(cs.sphere_pos_radius), f32c(cs.quad_origin),
        f32c(cs.quad_edge1), f32c(cs.quad_edge2), i32c(cs.tri_indices),
        f32c(cs.diffuse_color), f32c(cs.cb_color1), f32c(cs.cb_color2),
        f32c(cs.cb_scale), f32c(cs.emissive_power),
        f32c(cs.dielectric_ext_eta),
        int(MATERIAL_TAG_SHIFT), int(TAG_DIFFUSE), int(TAG_MIRROR),
        int(TAG_DIELECTRIC), int(TAG_EMISSIVE), int(TAG_DIFFUSECBOARD),
        np.ascontiguousarray(np.asarray(cs.camera_static), np.float64),
        int(width), int(height), int(max_bounces),
        seeds, offsets, int(n_sweeps),
        acc,
    )
    return acc
