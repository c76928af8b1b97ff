"""Build and load the hand-written CUDA kernels (``hijiki_tpu_torch/csrc``).

nvcc compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ctypes. The build runs at first use
and is cached under ``build/kernels/<key>/`` beside the package, where the
key is the sha256 of the sources and the flags, so an edited source can
never load a stale binary.

Run ``python -m hijiki_tpu_torch.utils.build`` to build (and print ptxas
register/spill reports) without rendering.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_ROOT = PKG.parent / "build" / "kernels"
LIB_NAME = "libhijiki_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SCENE = [_P, _P] + [_I] * 10
# argtypes of every C entry point: each pointer and the stream as c_void_p
SIGNATURES = {
    "mk_start": _SCENE + [_P, _P, _P, _I, _I, _P, _P, _P],
    "mk_resume": _SCENE + [_P, _P, _I, _I, _P, _P, _P],
    "reconstruct": [_P, _P, _F, _F, _F, _I, _I, _I, _P, _P],
}

_loaded: dict = {}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def cache_key() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine with the CUDA toolkit")
    return found


def build() -> tuple[Path, float, str]:
    """Compile the kernels unless the cached library exists. Returns (library
    path, seconds spent compiling, compiler report)."""
    out_dir = BUILD_ROOT / cache_key()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *[str(p) for p in sources() if p.suffix == ".cu"]]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.monotonic() - t0
    report = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{report}")
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib, secs, report


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    if "lib" not in _loaded:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded["lib"] = lib
    return _loaded["lib"]


if __name__ == "__main__":
    path, secs, report = build()
    print(report)
    print(f"{path} ({secs:.1f} s)")
