"""Build and load the hand-written CUDA kernels (``hijiki_tpu_torch/csrc``).

nvcc compiles every ``csrc/*.cu`` for ``sm_90a`` (one nvcc per source, all
started together) and links the objects into one shared library with a
plain C interface, loaded with ctypes. The build runs at first use and is
cached under ``build/kernels/<key>/`` beside the package, where the key is
the sha256 of the sources and the flags, so an edited source can never
load a stale binary.

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
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LINK_FLAGS = ("-shared",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SCENE = [_P, _P] + [_I] * 10
# argtypes of every C entry point: each pointer and the stream as c_void_p
SIGNATURES = {
    "mk_start": _SCENE + [_P, _P, _P, _I, _I, _P, _P, _P],
    "mk_resume": _SCENE + [_P, _P, _I, _I, _P, _P, _P],
    "mk_start_chained": _SCENE + [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "mk_tiles": _SCENE + [_P, _P, _P, _I, _I, _P, _P, _P],
    "mk_start_sorted": _SCENE + [_P, _P, _P, _I, _I, _P, _P, _P, _P],
    "mk_resume_sorted": _SCENE + [_P, _P, _I, _I, _P, _P, _P, _P],
    "mk_tiles_sorted": _SCENE + [_P, _P, _P, _I, _I, _P, _P, _P, _P],
    "sort_tiles": [_P, _P, _I, _I, _P, _P, _P],
    "reconstruct": [_P, _P, _F, _F, _F, _I, _I, _I, _P, _P],
    "traverse": [_P, _I, _P, _P, _P, _P, _I, _I, _P, _P],
    # the probes (csrc/probe_walk.cu, csrc/probe_latency.cu); the pointer
    # before the stream is the occupancy query's out-parameter (or null)
    "walk_ablate": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "walk_isolate": _SCENE + [_I, _I, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P],
    "latency_chain": [_I, _I, _P, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "staged_chase": [_I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
}

_loaded: dict = {}


def sources(csrc: Path = CSRC) -> list[Path]:
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def cache_key(csrc: Path = CSRC) -> str:
    h = hashlib.sha256()
    for p in sources(csrc):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine with the CUDA toolkit")
    return found


def build(csrc: Path = CSRC) -> tuple[Path, float, str]:
    """Compile the kernels of ``csrc`` (the package's sources, or an edited
    copy of them such as tools/probe_sort_tile.py's variants) unless the
    cached library exists. Returns (library path, seconds spent compiling,
    compiler report)."""
    out_dir = BUILD_ROOT / cache_key(csrc)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    pid = os.getpid()
    t0 = time.monotonic()
    objs, procs = [], []
    for src in (p for p in sources(csrc) if p.suffix == ".cu"):
        obj = out_dir / f"{src.stem}.{pid}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    report, failed = "", False
    for proc in procs:  # wait for every compile, so no process outlives the build
        report += proc.communicate()[0]
        failed |= proc.returncode != 0
    if failed:
        raise RuntimeError(f"nvcc failed:\n{report}")
    tmp = out_dir / f"{LIB_NAME}.{pid}.tmp"
    proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    report += proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{report}")
    for obj in objs:
        obj.unlink()
    secs = time.monotonic() - t0
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib, secs, report


def load_library(path: Path | None = None) -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process.
    ``path``: load that library (a ``build`` of other sources) in its place
    for every later launch."""
    if path is not None or "lib" not in _loaded:
        lib = ctypes.CDLL(str(path if path is not None else build()[0]))
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
