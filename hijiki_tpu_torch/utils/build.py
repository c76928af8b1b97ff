"""Build and load the hand-written CUDA kernels (``hijiki_tpu_torch/csrc``)
and the host libraries (``build_host``: one ``.cpp`` with g++).

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
# the g++-built host libraries (build_host): the OBJ parser, the BVH
# builder and the scalar oracle
NATIVE_ROOT = PKG.parent / "build" / "native"
LIB_NAME = "libhijiki_kernels.so"
REPORT_NAME = "ptxas.txt"
# --split-compile=0: the compiler's optimization passes on all cores (a
# source's kernels split into parts); megakernel.cu's 77 instantiations
# built in 31.0 s with it and 77.6 s without, every kernel at the same
# registers and spills (on an NVIDIA H100 80GB HBM3; PERF.md §6)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "--split-compile=0",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LINK_FLAGS = ("-shared",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
# csrc/walk.cuh SCENE_ARGS: rows, consts, the table's sizes and the bakes'
# counts (10), the packed format, payload rows, boxes, the shadow table,
# the occlusion cache and skip-all
_SCENE = [_P, _P] + [_I] * 13 + [_P, _I] + [_I, _I]
# argtypes of every C entry point: each pointer and the stream as c_void_p
SIGNATURES = {
    # K1, K4 and K5 are persistent: the pointer before the stream is the work counter
    "mk_start": _SCENE + [_P, _P, _P, _I, _I, _P, _P, _P, _P],
    # K2: its work buffer, the compaction's count of alive lanes (or null)
    # and the threshold before the stream (the survivor scan's: its own)
    "mk_resume": _SCENE + [_P, _P, _I, _I, _P, _P, _P, _P, _I, _P],
    "mk_resume_scan": [_P, _I, _I, _I, _P, _P],
    "mk_start_chained": _SCENE + [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "mk_occupancy": [_I, _P],
    "mk_tiles": _SCENE + [_P, _P, _P, _I, _I, _P, _P, _P, _P],
    "mk_start_sorted": _SCENE + [_P, _P, _P, _I, _I, _P, _P, _P, _P],
    "mk_resume_sorted": _SCENE + [_P, _P, _I, _I, _P, _P, _P, _P],
    "mk_tiles_sorted": _SCENE + [_P, _P, _P, _I, _I, _P, _P, _P, _P],
    "sort_tiles": [_P, _P, _I, _I, _P, _P, _P],
    # K3 takes its S sweeps' (S, 2) offsets as a host pointer
    "reconstruct": [_P, _P, _P, _I, _F, _I, _I, _I, _P, _P],
    # ... and with an (H, W) sample weight, the third pointer
    "reconstruct_weighted": [_P, _P, _P, _P, _I, _F, _I, _I, _I, _P, _P],
    "traverse": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    "reconstruct_occupancy": [_P],
    "traverse_occupancy": [_P],
    # the probes (csrc/probe_walk.cu, csrc/probe_latency.cu and those
    # below); the pointer before the stream is the occupancy query's
    # out-parameter (or null)
    "walk_ablate": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "walk_isolate": _SCENE + [_I, _I, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P],
    # mode, group, layout, tbl, rows, ncols, x, idx, n, iters, p0, threads, block
    "latency_chain": [_I, _I, _I, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "staged_chase": [_I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # csrc/reconstruct_old.cu (K9), csrc/probe_alu.cu (K11b)
    # K9 takes B's divisor constants (multiplier, shift) after B
    "reconstruct_old": [_P, _I, _I, _I, _I, _U, _I, _F, _F, _F, _F, _P, _P, _P],
    "alu_issue": [_I, _P, _I, _I, _I, _P, _P, _P],
    "dtype_elementwise": [_I, _I, _P, _I, _I, _I, _P, _P, _P],
    # dtype_slab takes its lanes a thread after the trip count
    "dtype_slab": [_I, _P, _P, _I, _I, _I, _I, _P, _P, _P],
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
    compiler report: ptxas' registers and spills of every kernel, kept
    beside a cached library)."""
    out_dir = BUILD_ROOT / cache_key(csrc)
    lib = out_dir / LIB_NAME
    if lib.exists():
        saved = out_dir / REPORT_NAME
        return lib, 0.0, saved.read_text() if saved.exists() else ""
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
    (out_dir / f"{REPORT_NAME}.{pid}").write_text(report)
    os.replace(out_dir / f"{REPORT_NAME}.{pid}", out_dir / REPORT_NAME)
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib, secs, report


def build_host(src: Path, flags: tuple) -> Path:
    """Compile the host library ``src`` (one ``.cpp`` with a plain C
    interface) with g++ and ``flags`` unless it is cached: returns
    ``build/native/<sha256 of the source and flags>/lib<stem>.so`` (with
    ``-march=native``, the host's target macros join the key). As in
    ``build``, the compiler writes a file of its own process and
    ``os.replace`` publishes it, so concurrent first uses never share a
    temporary file. Raises RuntimeError when g++ is missing or fails."""
    src = Path(src)
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host libraries build only with a C++ compiler")
    h = hashlib.sha256(src.read_bytes())
    h.update(b"\0" + " ".join(flags).encode())
    if "-march=native" in flags:
        # the host's instruction set: a checkout copied to another machine
        # must not load a library built for this one
        h.update(subprocess.run([gxx, "-march=native", "-dM", "-E", "-x", "c++", os.devnull],
                                capture_output=True).stdout)
    out_dir = NATIVE_ROOT / h.hexdigest()[:16]
    lib = out_dir / f"lib{src.stem}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *flags, "-shared", "-fPIC", "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {src.name} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib


def ptxas_table(report: str) -> dict:
    """{mangled kernel name: (registers, spill-store bytes)} of every entry
    function in ptxas' ``report``, in the report's order (the spill stores
    of the entry's own properties, not of a function it calls)."""
    import re

    out, entry, props, spill = {}, None, None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, props, spill = m.group(1), None, 0
            continue
        m = re.search(r"Function properties for '?([^' ]+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and props == entry:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.setdefault(entry, (int(m.group(1)), spill))
            entry = None
    return out


def ptxas_of(report: str, kernel: str, targs: str = "") -> tuple[int, int]:
    """(registers, spill-store bytes) that ptxas reports, in ``report``, for
    the kernel function named ``kernel`` in any namespace, or for its
    instantiation whose mangled template arguments are ``targs``
    (``ILi0ELb0E`` for <0, false>): its mangled name holds
    <length><kernel><targs>E. Raises KeyError if the report has none."""
    frag = f"{len(kernel)}{kernel}{targs}E"
    for name, regs_spill in ptxas_table(report).items():
        if frag in name:
            return regs_spill
    raise KeyError(f"ptxas reported no kernel {kernel}{targs}")


def spill_stores(report: str, kernel: str, targs: str = "") -> int:
    """The spill-store bytes of ``ptxas_of``."""
    return ptxas_of(report, kernel, targs)[1]


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
