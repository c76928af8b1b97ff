"""The port's native loaders against its Python/numpy paths and against the
JAX package's native ones, array for array: the BVH builder
(accel/bvh_builder.cpp, accel/native.py), the OBJ parser
(scene/obj_parser.cpp, scene/obj_native.py), the ``backend`` defaults of
``build_bvh`` and ``load_obj_scene`` ("auto", as JAX's), and their errors.
The C++ sources are copies of the JAX package's, built through
``utils.build.build_host`` into ``build/native/``."""

import os

import numpy as np
import pytest

from hijiki_tpu.accel.native import build_bvh_native as j_build_native
from hijiki_tpu.scene.compile import compile_scene as j_compile
from hijiki_tpu.scene.obj import load_obj_scene as j_load
from hijiki_tpu.scene.obj_native import parse_obj_native as j_parse_native
from hijiki_tpu_torch.accel import native as bvh_native
from hijiki_tpu_torch.accel.bvh import build_bvh
from hijiki_tpu_torch.scene import obj_native
from hijiki_tpu_torch.scene.bigscene import split_scene
from hijiki_tpu_torch.scene.compile import compile_scene
from hijiki_tpu_torch.scene.obj import load_obj_scene
from hijiki_tpu_torch.utils import build
from test_torch_scene import assert_same_compiled
from torch_port_helpers import MESHBOX, MESHBOX_SMALL, REPO

BVH_FIELDS = ("aabb_min", "aabb_max", "first", "count", "exit", "prim_order")


def _random_aabbs(n):
    """tests/test_native_bvh.py's boxes: seeded by n."""
    rng = np.random.default_rng(n)
    lo = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    ext = rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32)
    return lo, lo + ext


def _scene_aabbs(scene):
    """Each triangle's box, from its three vertices."""
    tris, _ = scene.triangles()
    p = np.asarray(scene.positions, np.float32)[tris]
    return p.min(axis=1), p.max(axis=1)


def _assert_same_bvh(a, b):
    for f in BVH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _three_builds(lo, hi, leaf_size):
    """The port's native and numpy trees equal each other and JAX's native
    tree, array for array."""
    native = build_bvh(lo, hi, leaf_size, backend="native")
    _assert_same_bvh(native, build_bvh(lo, hi, leaf_size, backend="numpy"))
    _assert_same_bvh(native, j_build_native(lo, hi, leaf_size))
    _assert_same_bvh(native, build_bvh(lo, hi, leaf_size))  # "auto"


def test_sources_are_the_jax_packages():
    """The three host sources are byte-for-byte copies."""
    for port, jax_src in (("accel/bvh_builder.cpp", "accel/bvh_builder.cpp"),
                          ("scene/obj_parser.cpp", "scene/obj_parser.cpp"),
                          ("ops/oracle_native.cpp", "ops/oracle_native.cpp")):
        a = open(os.path.join(REPO, "hijiki_tpu_torch", port), "rb").read()
        assert a == open(os.path.join(REPO, "hijiki_tpu", jax_src), "rb").read(), port


@pytest.mark.parametrize("leaf_size", [1, 4, 12])
@pytest.mark.parametrize("n", [1, 2, 7, 500, 100_000])
def test_bvh_random_boxes(leaf_size, n):
    _three_builds(*_random_aabbs(n), leaf_size)


@pytest.mark.parametrize("levels", [0, 1])
@pytest.mark.parametrize("leaf_size", [1, 4])
def test_bvh_meshbox(levels, leaf_size):
    """The meshbox's triangles, and its 4-to-1 split (25,096 triangles)."""
    scene = load_obj_scene(MESHBOX)
    if levels:
        scene = split_scene(scene, levels)
    _three_builds(*_scene_aabbs(scene), leaf_size)


def test_host_library_cache_layout(monkeypatch, tmp_path):
    """Each library lands in build/native/<key>/lib<stem>.so, its key the
    sha256 of the source and the flags; no temporary file stays behind."""
    assert build.NATIVE_ROOT == build.PKG.parent / "build" / "native"
    monkeypatch.setattr(build, "NATIVE_ROOT", tmp_path)
    for src, flags in ((bvh_native.SRC, bvh_native.FLAGS),
                       (obj_native.SRC, obj_native.FLAGS)):
        lib = build.build_host(src, flags)
        assert lib.parent.parent == tmp_path and lib.name == f"lib{src.stem}.so"
        assert [p.name for p in lib.parent.iterdir()] == [lib.name]
        assert build.build_host(src, flags) == lib  # cached
    other = build.build_host(bvh_native.SRC, bvh_native.FLAGS + ("-DHIJIKI_KEY_TEST",))
    assert other.parent != lib.parent and len(list(tmp_path.iterdir())) == 3


def _assert_scene_equal(a, b):
    """a = python (Triangle objects), b = native (bulk arrays)."""
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.normals, b.normals)
    np.testing.assert_array_equal(a.uvs, b.uvs)
    tri_a = np.array([t.indices for t, _ in a.objects], np.int32).reshape(-1, 3)
    mat_a = np.array([m for _, m in a.objects], np.int32)
    np.testing.assert_array_equal(tri_a, b.bulk_tris)
    np.testing.assert_array_equal(mat_a, b.bulk_tri_mats)
    assert [repr(m) for m in a.materials] == [repr(m) for m in b.materials]


def _assert_parse_equal(path):
    """The port's native parse equals JAX's native parse, array for array
    and material for material; its scene equals the port's Python parse."""
    got, want = obj_native.parse_obj_native(str(path)), j_parse_native(str(path))
    for x, y in zip(got[:5], want[:5]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert got[5] == want[5]
    a = load_obj_scene(str(path), backend="python")
    b = load_obj_scene(str(path), backend="native")
    _assert_scene_equal(a, b)
    return a, b


@pytest.mark.parametrize("path", [MESHBOX, MESHBOX_SMALL], ids=["meshbox", "meshbox_small"])
def test_obj_meshbox(path):
    a, b = _assert_parse_equal(path)
    assert [repr(m) for m in b.materials] == [repr(m) for m in j_load(path).materials]


# the synthetic files of tests/test_obj_native.py
SYNTHETIC = {
    "smoothing": (
        "newmtl white\nKd 0.8 0.8 0.8\nnewmtl lighty\nKe 5 5 5\n",
        "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 1 0 1\nv 0 1 1\nv 0 2 0\nusemtl white\n"
        "s 1\nf 1 2 3\nf 1 3 4\ns off\nf 1 2 5\nf -5 -3 -1\n",
    ),
    "mixed_uv_skipped": (
        "newmtl red\nKd 1 0 0\n",
        "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0.5 0.5\nvn 0 0 1\nf 1 2 3\n"
        "usemtl red\nf 1/1/1 2/1 3//1\ng other\nf 1/1/1 2/1 3//1\n"
        "usemtl unknown_material\nf 1 2 3\n",
    ),
    "duplicate_newmtl": (
        "newmtl red\nKd 1 0 0\nnewmtl lightA\nKe 5 5 5\nnewmtl red\nKd 0 1 0\n"
        "newmtl lightA\nKd 0.5 0.5 0.5\nnewmtl blue\nKd 0 0 1\n",
        "mtllib m.mtl\nmtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nusemtl red\nf 1 2 3\n"
        "usemtl blue\nf 1 2 3\nusemtl lightA\nf 1 2 3\n",
    ),
    "fan": (
        "newmtl w\nKd 1 1 1\n",
        "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 2 0 0\nvn 0 0 1\nusemtl w\n"
        "f 1//1 2//1 3//1 4//1 5//1\n",
    ),
}


@pytest.mark.parametrize("name", list(SYNTHETIC))
def test_obj_synthetic(name, tmp_path):
    mtl, obj = SYNTHETIC[name]
    (tmp_path / "m.mtl").write_text(mtl)
    path = tmp_path / f"{name}.obj"
    path.write_text(obj)
    a, b = _assert_parse_equal(path)
    n_tris = {"smoothing": 4, "mixed_uv_skipped": 2, "duplicate_newmtl": 3, "fan": 3}[name]
    assert b.bulk_tris.shape[0] == n_tris  # skipped faces skipped, fans split
    np.testing.assert_array_equal(compile_scene(a).materials, compile_scene(b).materials)


@pytest.mark.parametrize("bad_face", ["f -5 -3 -2", "f 1 2 9"])
def test_obj_out_of_range_index(bad_face, tmp_path):
    """An out-of-range face index fails both backends, as in JAX's."""
    (tmp_path / "m.mtl").write_text("newmtl white\nKd 0.8 0.8 0.8\n")
    p = tmp_path / "bad.obj"
    p.write_text(f"mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 1 0 1\nv 0 1 1\nusemtl white\n{bad_face}\n")
    assert obj_native.parse_obj_native(str(p)) is None and j_parse_native(str(p)) is None
    with pytest.raises((ValueError, IndexError)):
        load_obj_scene(str(p), backend="python")
    with pytest.raises(ValueError, match="parse failed"):
        load_obj_scene(str(p), backend="native")


@pytest.mark.parametrize("path", [MESHBOX_SMALL, MESHBOX], ids=["meshbox_small", "meshbox"])
def test_default_compile_equals_jax_default(path):
    """Every default (the native parser, the native builder, JAX's compile
    defaults) against JAX's default load and compile: every array equal;
    and the numpy builder's compile equal to it on these scenes."""
    j_scene, scene = j_load(path), load_obj_scene(path)
    assert scene.bulk_tris.shape[0] > 0 and not scene.objects  # the native parser's bulk
    j_scene.put_cbox_spheres()
    scene.put_cbox_spheres()
    cs = compile_scene(scene)
    assert_same_compiled(j_compile(j_scene), cs)


def test_numpy_builder_compile_equals_native(monkeypatch):
    """compile_scene through the numpy builder gives the native builder's
    compiled scene on the meshbox + spheres."""
    from hijiki_tpu_torch.scene import compile as sc

    scene = load_obj_scene(MESHBOX_SMALL)
    scene.put_cbox_spheres()
    want = compile_scene(scene)
    monkeypatch.setattr(sc, "build_bvh", lambda mn, mx, leaf_size=1: build_bvh(
        mn, mx, leaf_size, backend="numpy"))
    assert_same_compiled(compile_scene(scene), want)


def test_native_unavailable_raises(monkeypatch):
    """Without the host libraries, "native" raises JAX's errors and "auto"
    falls back to the Python parser and the numpy builder."""
    monkeypatch.setattr(obj_native, "load_library", lambda: None)
    monkeypatch.setattr(bvh_native, "load_library", lambda: None)
    with pytest.raises(RuntimeError, match="native OBJ parser unavailable"):
        load_obj_scene(MESHBOX_SMALL, backend="native")
    with pytest.raises(RuntimeError, match="native BVH builder unavailable"):
        build_bvh(*_random_aabbs(7), backend="native")
    scene = load_obj_scene(MESHBOX_SMALL)
    assert scene.bulk_tris.shape[0] == 0 and len(scene.objects) == 306
    lo, hi = _random_aabbs(500)
    _assert_same_bvh(build_bvh(lo, hi, 4), j_build_native(lo, hi, 4))


def test_failed_build_falls_back(monkeypatch, tmp_path):
    """A source g++ cannot compile: build_host raises, load_library returns
    None (once, then remembers), and "auto" builds with numpy."""
    bad = tmp_path / "bvh_builder.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(bvh_native, "SRC", bad)
    monkeypatch.setattr(bvh_native, "_lib", None)
    monkeypatch.setattr(bvh_native, "_load_failed", False)
    monkeypatch.setattr(build, "NATIVE_ROOT", tmp_path / "native")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        build.build_host(bad, bvh_native.FLAGS)
    assert bvh_native.load_library() is None and bvh_native._load_failed
    lo, hi = _random_aabbs(7)
    _assert_same_bvh(build_bvh(lo, hi, 1), build_bvh(lo, hi, 1, backend="numpy"))
    assert not list((tmp_path / "native").rglob("*.so"))
