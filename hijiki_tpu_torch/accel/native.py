"""ctypes bindings for the native C++ BVH builder (``bvh_builder.cpp``).

The source is a copy of ``hijiki_tpu/accel/bvh_builder.cpp``, built with
its flags (``-O3 -march=native``) through ``utils.build.build_host``: a
plain C ABI, cached under ``build/native/`` by the sha256 of the source and
the flags. ``load_library`` returns None where no compiler is available, and
``build_bvh(backend="auto")`` then falls back to the numpy builder.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).with_name("bvh_builder.cpp")
FLAGS = ("-O3", "-march=native")
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def load_library() -> Optional[ctypes.CDLL]:
    """Compile (if needed) and load the native builder; None if unavailable."""
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
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.hijiki_build_bvh.restype = ctypes.c_int32
    lib.hijiki_build_bvh.argtypes = [
        f32p, f32p, ctypes.c_int32, ctypes.c_int32, f32p, f32p, i32p, i32p, i32p, i32p,
    ]
    _lib = lib
    return lib


def build_bvh_native(aabb_min: np.ndarray, aabb_max: np.ndarray, leaf_size: int = 1):
    """Native binned-SAH build; returns a FlatBVH or None if unavailable."""
    from hijiki_tpu_torch.accel.bvh import FlatBVH

    lib = load_library()
    if lib is None:
        return None
    aabb_min = np.ascontiguousarray(aabb_min, dtype=np.float32).reshape(-1, 3)
    aabb_max = np.ascontiguousarray(aabb_max, dtype=np.float32).reshape(-1, 3)
    n = aabb_min.shape[0]
    max_nodes = max(2 * n - 1, 1)
    out_min = np.empty((max_nodes, 3), np.float32)
    out_max = np.empty((max_nodes, 3), np.float32)
    first = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    exit_ = np.empty(max_nodes, np.int32)
    order = np.empty(n, np.int32)
    num = lib.hijiki_build_bvh(
        aabb_min, aabb_max, n, leaf_size, out_min, out_max, first, count, exit_, order
    )
    if num < 0:
        return None
    return FlatBVH(
        aabb_min=out_min[:num].copy(),
        aabb_max=out_max[:num].copy(),
        first=first[:num].copy(),
        count=count[:num].copy(),
        exit=exit_[:num].copy(),
        prim_order=order,
    )
