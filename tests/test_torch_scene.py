"""The port's host layer against hijiki_tpu: OBJ loading, the in-repo
meshbox scene, and the compiled-scene arrays and bakes, exactly."""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from hijiki_tpu.scene.compile import compile_scene as j_compile
from hijiki_tpu.scene.obj import load_obj_scene as j_load
from hijiki_tpu.scene.presets import load_preset as j_preset
from hijiki_tpu_torch.scene.compile import compile_scene, to_device
from hijiki_tpu_torch.scene.obj import load_obj_scene
from hijiki_tpu_torch.scene.presets import load_preset
from torch_port_helpers import MESHBOX, MESHBOX_SMALL, REPO, mixed_scene, port_scene

def assert_same_compiled(a, b):
    """Every field of the two compiled scenes equal: arrays bit for bit (the
    dedicated shadow table included, or None in both), statics by value."""
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if y is None or x is None:
            assert x is None and y is None, f.name
        elif isinstance(y, np.ndarray):
            x = np.asarray(x)
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def _scenes(name):
    if name.startswith("builtin:"):
        return j_preset(name[8:]), load_preset(name[8:])
    if name == "mixed":
        return mixed_scene("hijiki_tpu"), mixed_scene("hijiki_tpu_torch")
    path = MESHBOX_SMALL if name == "meshbox_small" else MESHBOX
    a, b = j_load(path), load_obj_scene(path)
    a.put_cbox_spheres()
    b.put_cbox_spheres()
    return a, b


_NAMES = ["builtin:cornell", "builtin:cornell-spheres", "builtin:cornell-glass",
          "meshbox_small", "mixed"]


@pytest.mark.parametrize(
    "name,boxes",
    [pytest.param(n, True, id=n) for n in _NAMES]
    + [pytest.param(n, False, id=f"{n}-noboxes") for n in _NAMES],
)
def test_compiled_scene_identical(name, boxes):
    """Every array and bake of compile_scene, bit for bit, with the
    shadow-visibility boxes (the default of both packages) and without (the
    reference compiles with its default native BVH builder; the port's
    numpy builder produces the same trees on these scenes)."""
    ja, tb = _scenes(name)
    assert_same_compiled(j_compile(ja, shadow_vis_boxes=boxes),
                         compile_scene(tb, shadow_vis_boxes=boxes))


def test_meshbox_full_compiles_identically():
    """The JAX package's default compile of the in-repo scene: 16 proven
    shadow-visibility boxes and the 4,503-row PACKED3 shadow table."""
    ja, tb = _scenes("meshbox")
    cs = compile_scene(tb)
    assert_same_compiled(j_compile(ja), cs)
    assert 6000 <= cs.num_triangles <= 6500 and cs.num_spheres == 2
    assert cs.mega_num_tables_static == 1  # a single table: too big for 8
    assert cs.mega_packed_static == 0 and cs.shadow_vis_static[0] == 16
    assert cs.shadow_rows_mega.shape == (4503, 32) and cs.shadow_tbl_rows_static == 4503


def test_meshbox_loads_in_both_packages():
    a, b = j_load(MESHBOX_SMALL, backend="python"), load_obj_scene(MESHBOX_SMALL, backend="python")
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.normals, b.normals)
    assert [type(m).__name__ for m in a.materials] == [type(m).__name__ for m in b.materials]
    names = [type(m).__name__ for m in b.materials]
    assert "Emissive" in names and len(b.objects) == 306
    # smooth per-vertex normals: the torus normals are unit and not all equal
    n = b.normals
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("size", ["small", "full"])
def test_meshbox_generator_reproduces_committed_files(size, tmp_path):
    spec = importlib.util.spec_from_file_location(
        "make_meshbox", os.path.join(REPO, "tools", "make_meshbox.py")
    )
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    name = "meshbox.obj" if size == "full" else "meshbox_small.obj"
    out = tmp_path / name
    gen.write(str(out), size)
    committed = os.path.join(REPO, "scenes", "meshbox", name)
    assert out.read_bytes() == open(committed, "rb").read()
    mtl = name.replace(".obj", ".mtl")
    assert (tmp_path / mtl).read_bytes() == open(committed.replace(".obj", ".mtl"), "rb").read()


def test_from_reference_and_to_device():
    """from_reference carries every field, the dedicated shadow table and
    the boxes included."""
    ja, _ = _scenes("meshbox_small")
    jcs = j_compile(ja)
    pcs = port_scene(jcs)
    assert pcs.shadow_rows_mega.shape == (215, 32) and pcs.shadow_vis_static[0] == 16
    assert_same_compiled(jcs, pcs)
    dcs = to_device(pcs, "cpu")
    assert isinstance(dcs.trace_rows_mega, torch.Tensor)
    assert dcs.materials.dtype == torch.int64  # u32 widened
    np.testing.assert_array_equal(dcs.trace_rows_mega.numpy(), pcs.trace_rows_mega)


def test_port_never_imports_jax():
    """`import hijiki_tpu_torch` and its modules, and the port's card tools
    (chip_smoke.py, tools/ab_megakernel_torch.py with what its main()
    imports), leave jax out of sys.modules (a fresh interpreter: this test
    process has jax loaded already)."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import hijiki_tpu_torch, hijiki_tpu_torch.cli\n"
        "import hijiki_tpu_torch.render.renderer, hijiki_tpu_torch.ops.megakernel\n"
        "import hijiki_tpu_torch.utils.build, hijiki_tpu_torch.scene.compile\n"
        "import hijiki_tpu_torch.probes.walk_probe, hijiki_tpu_torch.scene.obj\n"
        "import hijiki_tpu_torch.scene.lightvis, hijiki_tpu_torch.scene.bigscene\n"
        "import hijiki_tpu_torch.accel.native, hijiki_tpu_torch.scene.obj_native\n"
        "import hijiki_tpu_torch.ops.oracle, hijiki_tpu_torch.ops.oracle_native\n"
        "sys.path.insert(0, 'tools')\n"
        "import chip_smoke, ab_megakernel_torch\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'hijiki_tpu.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("name", ["meshbox_small", "mixed", "builtin:cornell-glass"])
def test_device_scene_equals_reference(name):
    """The scene the sync and wavefront drivers read (``to_device`` of the
    port's own compile) holds hijiki_tpu's ``scene_to_device`` arrays,
    value for value (u32 handles widened to int64, numpy scalars such as
    cam_fov as 0-d tensors)."""
    from hijiki_tpu.scene.compile import scene_to_device

    ja, pa = _scenes(name)
    jd = scene_to_device(j_compile(ja))
    pd = to_device(compile_scene(pa), "cpu")
    n = 0
    for f in dataclasses.fields(pd):
        y = getattr(pd, f.name)
        if not isinstance(y, torch.Tensor):
            continue
        x = np.asarray(getattr(jd, f.name))
        np.testing.assert_array_equal(y.numpy(), x.astype(y.numpy().dtype), err_msg=f.name)
        n += 1
    assert n >= 30 and isinstance(pd.cam_fov, torch.Tensor) and pd.materials.dtype == torch.int64
