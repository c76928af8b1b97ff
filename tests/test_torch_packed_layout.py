"""The packed prim rows' layout as the render walk reads it, checked on the
CPU against the JAX package's and the plain version's.

``csrc/walk.cuh``'s ``packed_test`` reads prim k of a packed row at
``packed_base<kFmt>(k)`` (its slot, where the slots run on from prim 0's,
at ``packed_slot_col<kFmt>()``) in a row of ``packed_width<kFmt>()``
columns. Those constexpr functions are cut out of the header, compiled with
the host's C++ compiler and evaluated: the bases, widths and slot columns
are those of ``hijiki_tpu/scene/compile.py`` and ``ops/megakernel.py``, and
every column a prim's test reads lies inside its row, whose width keeps
each row 16-byte aligned for the row step's ``float4`` loads."""

import re
import shutil
import subprocess

import pytest

from hijiki_tpu.scene import compile as jcompile
from hijiki_tpu_torch.ops import megakernel as mk
from hijiki_tpu_torch.utils import build

FORMATS = (1, 3, 4, 12)


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """{format: (prims, width, slot column, bases)} from walk.cuh's own
    constexpr functions, compiled and run on the host."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler"
    src = (build.CSRC / "walk.cuh").read_text()
    m = re.search(r"template <int kFmt>\n__host__ __device__ constexpr int packed_n\(\).*?"
                  r"constexpr int packed_slot_col\(\) \{.*?\n\}\n", src, re.S)
    assert m, "walk.cuh's packed_n .. packed_slot_col"
    funcs = m.group(0).replace("__host__ __device__ ", "")
    main = "".join(
        f'  std::printf("{f} %d %d %d", packed_n<{f}>(), packed_width<{f}>(), '
        f"packed_slot_col<{f}>());\n"
        f'  for (int k = 0; k < packed_n<{f}>(); ++k) std::printf(" %d", packed_base<{f}>(k));\n'
        '  std::printf("\\n");\n' for f in FORMATS)
    tmp = tmp_path_factory.mktemp("packed_layout")
    (tmp / "layout.cpp").write_text(f"#include <cstdio>\n{funcs}\nint main() {{\n{main}  return 0;\n}}\n")
    subprocess.run([cxx, "-std=c++17", "-o", str(tmp / "layout"), str(tmp / "layout.cpp")],
                   check=True, capture_output=True, timeout=120)
    out = subprocess.run([str(tmp / "layout")], check=True, capture_output=True, text=True,
                         timeout=60).stdout
    got = {}
    for line in out.splitlines():
        fmt, n, width, slot, *bases = map(int, line.split())
        got[fmt] = (n, width, slot, tuple(bases))
    return got


@pytest.mark.parametrize("fmt", FORMATS)
def test_layout_equals_jax_and_plain(layout, fmt):
    """Prims, bases, widths and slot columns: walk.cuh's equal the JAX
    compile's constants and the plain version's ``_PACKED_BASES``."""
    n, width, slot, bases = layout[fmt]
    jax = {1: ((0,), jcompile.SLIM_ROW_WIDTH, jcompile.SLIM_SLOT_COL),
           3: (jcompile.PACKED3_BASES, 32, jcompile.PACKED3_SLOT_COL),
           4: (tuple(jcompile.PACKED_BASE + jcompile.PACKED_STRIDE * k
                     for k in range(jcompile.PACKED_N)), jcompile.PACKED_ROW_WIDTH, None),
           12: (jcompile.PACKED12_BASES, jcompile.PACKED12_ROW_WIDTH, jcompile.PACKED12_SLOT_COL)}
    want_bases, want_width, want_slot = jax[fmt]
    assert n == len(bases)
    assert bases == tuple(want_bases) == tuple(mk._PACKED_BASES[fmt])
    assert width == want_width
    if want_slot is not None:
        assert slot == want_slot == mk._SLOT_COL[fmt]


@pytest.mark.parametrize("fmt", FORMATS)
def test_prims_lie_inside_their_aligned_row(layout, fmt):
    """Every column a prim's test reads (v0, edge1, edge2, and format 4's
    normal and slot) and the slot column lie inside the row, no two prims
    share a column, the slot column is no prim's, and the row's width keeps
    every row 16-byte aligned (row4's float4 loads)."""
    n, width, slot, bases = layout[fmt]
    ncol = 13 if fmt == 4 else 9
    cols = [c for B in bases for c in range(B, B + ncol)]
    assert all(0 <= c < width for c in cols)
    assert len(set(cols)) == len(cols)
    if fmt != 4:
        assert 0 <= slot < width and slot not in cols
    assert width % 4 == 0
