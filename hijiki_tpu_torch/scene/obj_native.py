"""ctypes bindings for the native C++ OBJ/MTL parser (``obj_parser.cpp``).

The source is a copy of ``hijiki_tpu/scene/obj_parser.cpp``, built with its
flags through ``utils.build.build_host`` (cached under ``build/native/``),
with the same None fallback as ``accel/native.py`` where no compiler is
available. ``-ffp-contract=off`` keeps the generated-normal math
bit-identical to the numpy reference path (no FMA contraction).
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).with_name("obj_parser.cpp")
FLAGS = ("-O3", "-march=native", "-ffp-contract=off")
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def load_library() -> Optional[ctypes.CDLL]:
    """Compile (if needed) and load the native parser; None if unavailable."""
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
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.hijiki_obj_parse.restype = ctypes.c_void_p
    lib.hijiki_obj_parse.argtypes = [ctypes.c_char_p]
    lib.hijiki_obj_counts.restype = None
    lib.hijiki_obj_counts.argtypes = [ctypes.c_void_p, i64p]
    lib.hijiki_obj_fill.restype = None
    lib.hijiki_obj_fill.argtypes = [
        ctypes.c_void_p, f32p, f32p, f32p, i32p, i32p, f64p, f64p, i32p, ctypes.c_char_p,
    ]
    lib.hijiki_obj_free.restype = None
    lib.hijiki_obj_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def parse_obj_native(path: str):
    """Parse an OBJ with the native parser.

    Returns (positions (V,3) f32, normals (V,3) f32, uvs (V,2) f32,
    tris (T,3) i32, tri_mat (T,) i32, materials: list of
    (name, kd (3,), ke (3,) | None)) — or None if the native parser is
    unavailable or the file can't be opened.
    """
    lib = load_library()
    if lib is None:
        return None
    h = lib.hijiki_obj_parse(os.fsencode(path))
    if not h:
        return None
    try:
        counts = np.zeros(4, np.int64)
        lib.hijiki_obj_counts(h, counts)
        nv, nt, nm, nb = (int(x) for x in counts)
        pos = np.empty((max(nv, 1), 3), np.float32)
        nrm = np.empty((max(nv, 1), 3), np.float32)
        uv = np.empty((max(nv, 1), 2), np.float32)
        tris = np.empty((max(nt, 1), 3), np.int32)
        tmat = np.empty(max(nt, 1), np.int32)
        kd = np.empty((max(nm, 1), 3), np.float64)
        ke = np.empty((max(nm, 1), 3), np.float64)
        has_ke = np.empty(max(nm, 1), np.int32)
        names = ctypes.create_string_buffer(max(nb, 1))
        lib.hijiki_obj_fill(h, pos, nrm, uv, tris, tmat, kd, ke, has_ke, names)
        name_list = names.raw[: max(nb - 1, 0)].split(b"\0") if nm else []
        mats = [
            (
                name_list[i].decode("utf-8", "replace"),
                tuple(float(x) for x in kd[i]),
                tuple(float(x) for x in ke[i]) if has_ke[i] else None,
            )
            for i in range(nm)
        ]
        return pos[:nv], nrm[:nv], uv[:nv], tris[:nt], tmat[:nt], mats
    finally:
        lib.hijiki_obj_free(h)
