"""The port's packed trace-row formats, dedicated shadow table and
shadow-visibility boxes against hijiki_tpu's, on the host side: compiled
scenes equal array for array for every packed_leaf with the boxes on, the
lightvis boxes equal as tuples, their soundness against the twin's any-hit
walk, and the 4-to-1 split scene that makes "auto" pack."""

import numpy as np
import pytest
import torch

from hijiki_tpu.scene.compile import compile_scene as j_compile
from hijiki_tpu.scene.lightvis import build_shadow_vis_boxes as j_boxes
from hijiki_tpu.scene.obj import load_obj_scene as j_load
from hijiki_tpu.scene.presets import load_preset as j_preset
from hijiki_tpu_torch.ops import megakernel as mk
from hijiki_tpu_torch.scene import lightvis
from hijiki_tpu_torch.scene.bigscene import split_scene
from hijiki_tpu_torch.scene.compile import (
    KIND_QUAD, KIND_SPHERE, KIND_TRIANGLE, MEGA_VMEM_TABLE_BYTES, PACKED_ROW_WIDTH,
    compile_scene,
)
from hijiki_tpu_torch.scene.obj import load_obj_scene
from hijiki_tpu_torch.scene.presets import load_preset
from test_fuzz_oracle import random_scene
from test_torch_scene import assert_same_compiled
from torch_port_helpers import MESHBOX, MESHBOX_SMALL

FORMATS = ["auto", 0, 1, 3, 4, 12]


def _to_port(s):
    """A hijiki_tpu Scene rebuilt with the port's model classes."""
    import dataclasses

    from hijiki_tpu_torch.scene import model as m

    conv = lambda x: getattr(m, type(x).__name__)(
        **{f.name: getattr(x, f.name) for f in dataclasses.fields(x)})
    return m.Scene(camera=conv(s.camera), objects=[(conv(o), k) for o, k in s.objects],
                   materials=[conv(x) for x in s.materials], positions=s.positions,
                   normals=s.normals, uvs=s.uvs, bulk_tris=s.bulk_tris,
                   bulk_tri_mats=s.bulk_tri_mats)


def _pair(name):
    """(hijiki_tpu's scene, the port's) of one source; the fuzz scenes are
    built once with hijiki_tpu's model and compiled by both packages."""
    if name.startswith("builtin:"):
        return j_preset(name[8:]), load_preset(name[8:])
    if name.startswith("fuzz:"):
        s = random_scene(int(name[5:]))
        return s, _to_port(s)
    a, b = j_load(MESHBOX_SMALL), load_obj_scene(MESHBOX_SMALL)
    a.put_cbox_spheres()
    b.put_cbox_spheres()
    return a, b


@pytest.mark.parametrize("packed", FORMATS, ids=str)
@pytest.mark.parametrize("name", ["meshbox_small", "builtin:cornell-spheres", "builtin:cornell-glass",
                                  "fuzz:77", "fuzz:123"])
def test_compiled_scene_identical_per_format(name, packed):
    """compile_scene(packed_leaf=...) with the boxes on: every array (the
    packed walk tables, the payload section, the dedicated shadow table)
    and every static (the format, table and payload rows, the boxes) bit
    for bit."""
    ja, pa = _pair(name)
    jcs, pcs = j_compile(ja, packed_leaf=packed), compile_scene(pa, packed_leaf=packed)
    assert_same_compiled(jcs, pcs)
    if pcs.mega_analytic_mode_static and pcs.num_triangles and packed not in ("auto", 0):
        assert pcs.mega_packed_static == {1: 1, 3: 3, 4: 4, 12: 12}[packed]
        assert pcs.shadow_rows_mega is None
        ntab, rp = pcs.mega_num_tables_static, pcs.mega_tbl_rows_static
        assert pcs.trace_rows_mega.shape[0] == ntab * rp + pcs.mega_pay_rows_static


@pytest.mark.parametrize("name", ["meshbox_small", "builtin:cornell", "fuzz:77", "fuzz:123"])
@pytest.mark.parametrize("target", [512, 8192])
def test_lightvis_boxes_equal(name, target, tmp_path, monkeypatch):
    """The port's proof gives hijiki_tpu's boxes as tuples, on the same
    numpy inputs (JAX's cache in a temporary directory, so its answer is
    computed)."""
    monkeypatch.setenv("HIJIKI_CACHE_DIR", str(tmp_path))
    ja, _ = _pair(name)
    jcs = j_compile(ja, shadow_vis_boxes=False)
    order = np.argsort(np.asarray(jcs.prim_shape_id))
    a, b, c = (np.asarray(x)[order] for x in (jcs.prim_a, jcs.prim_b, jcs.prim_c))
    kind = np.asarray(jcs.prim_kind)[order]
    # the compiler's per-shape AABBs (sphere: center -+ radius; else the
    # vertices' or corners' box)
    corners = np.stack([a, a + b, a + c, a + b + c])
    lo = np.where(kind[:, None] == KIND_SPHERE, a - b[:, :1], corners[:3].min(0))
    hi = np.where(kind[:, None] == KIND_SPHERE, a + b[:, :1], corners[:3].max(0))
    quad = kind == KIND_QUAD
    lo[quad], hi[quad] = corners[:, quad].min(0), corners[:, quad].max(0)
    em = np.asarray(jcs.emitter_shape)[: jcs.num_emitters]
    args = (lo.astype(np.float32), hi.astype(np.float32), kind, a, b, c, em,
            KIND_SPHERE, KIND_QUAD, KIND_TRIANGLE)
    want = j_boxes(*args, target=target)
    got = lightvis.build_shadow_vis_boxes(*args, target=target)
    assert got == want


def test_lightvis_cache_in_the_port(monkeypatch, tmp_path):
    """The port caches its proof under its own build/lightvis (a second call
    reads it back), never in the reference's cache directory."""
    monkeypatch.setenv("HIJIKI_CACHE_DIR", str(tmp_path))
    s = load_obj_scene(MESHBOX_SMALL)
    s.put_cbox_spheres()
    first = compile_scene(s).shadow_vis_static
    assert first and first[0] > 0
    assert compile_scene(s).shadow_vis_static == first
    assert lightvis._cache_dir().endswith("build/lightvis") and not list(tmp_path.iterdir())


def _walk_any(ms, o, d, tmax):
    """The twin's any-hit walk of rays o + t d, t in [2e-4, tmax)."""
    to = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))
    o, d = to(o), to(d)
    tmin = torch.full((o.shape[0],), mk._f(2.0 * mk.M_EPS))
    hit = mk._trace_any(ms, tuple(o.T), tuple(d.T), tmin, to(tmax))[0]
    return hit.numpy()


@pytest.mark.parametrize("shadow_tbl", [False, True])
def test_boxes_are_sound_against_the_twin(shadow_tbl):
    """tests/test_lightvis.py:55 on the port: shadow rays from points inside
    the proven boxes to points sampled on the emitters are never occluded
    by the twin's any-hit walk (over the main table, or the dedicated
    shadow table)."""
    s = load_obj_scene(MESHBOX_SMALL)
    s.put_cbox_spheres()
    cs = compile_scene(s)
    ms = mk.launch_scene(mk.mega_scene(cs, 8, 8, "cpu"), shadow_tbl=shadow_tbl)
    assert ms.nbox > 0
    rng = np.random.default_rng(0)
    n_per = 256
    origins = np.concatenate([
        b[:3] + (b[3:] - b[:3]) * rng.random((n_per, 3)) for b in ms.boxes.astype(np.float64)
    ])
    # points on the emitters (triangles: the baked geometry's vertices)
    em = [e for e in cs.emitter_bake_static if e[0] == KIND_TRIANGLE]
    assert em
    pts = []
    for k in range(origins.shape[0]):
        g = np.asarray(em[k % len(em)][6:15], np.float64).reshape(3, 3)
        u, v = rng.random(2)
        if u + v > 1:
            u, v = 1 - u, 1 - v
        pts.append(g[0] + u * (g[1] - g[0]) + v * (g[2] - g[0]))
    pts = np.asarray(pts)
    sv = pts - origins
    dist = np.linalg.norm(sv, axis=1)
    hit = _walk_any(ms, origins, sv / dist[:, None], dist - mk.M_EPS)
    assert not hit.any(), f"{int(hit.sum())} shadow rays from proven boxes were occluded"
    # the same walk does find occluders from outside the boxes
    lo, hi = np.asarray(cs.bbox_static[:3]), np.asarray(cs.bbox_static[3:])
    out = lo + (hi - lo) * rng.random((2048, 3))
    sv = np.resize(pts, out.shape) - out
    dist = np.linalg.norm(sv, axis=1)
    assert _walk_any(ms, out, sv / dist[:, None], dist - mk.M_EPS).any()


def test_split_scene_packs_past_the_table_limit():
    """Two 4-to-1 splits of meshbox + spheres: 100,384 triangles, every
    material kept, the same bounds; compile_scene's auto packs it (PACKED4:
    the classic table would pass MEGA_VMEM_TABLE_BYTES) and skips the box
    proof (more than lightvis.MAX_PRIMS prims), where one split stays
    classic."""
    s = load_obj_scene(MESHBOX)
    s.put_cbox_spheres()
    tris, mats = s.triangles()
    big = split_scene(s, 2)
    btris, bmats = big.triangles()
    assert btris.shape == (16 * len(tris), 3) == (100384, 3)
    np.testing.assert_array_equal(bmats, np.repeat(mats, 16))
    assert [type(o).__name__ for o, _ in big.objects] == ["Sphere", "Sphere"]
    pos = big.positions[btris.ravel()]
    np.testing.assert_allclose(pos.min(0), s.positions[tris.ravel()].min(0), atol=1e-6)
    np.testing.assert_allclose(pos.max(0), s.positions[tris.ravel()].max(0), atol=1e-6)
    # a child's corner triangle shares its parent's corner vertex
    np.testing.assert_array_equal(big.positions[btris[0, 0]], s.positions[tris[0, 0]])
    assert 3 * 25096 // 2 * 32 * 4 <= MEGA_VMEM_TABLE_BYTES  # one split: classic
    cs = compile_scene(big)
    assert cs.num_triangles == 100384 and cs.mega_packed_static == 4
    assert cs.trace_rows_mega.shape[1] == PACKED_ROW_WIDTH and cs.shadow_rows_mega is None
    assert cs.shadow_vis_static == () and cs.mega_num_tables_static == 1
    assert cs.mega_pay_rows_static == 100384
    assert cs.trace_rows_mega.shape[0] == cs.mega_tbl_rows_static + 100384
