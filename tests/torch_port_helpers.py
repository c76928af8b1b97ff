"""Shared helpers of the tests/test_torch_*.py files: carry a scene compiled
by hijiki_tpu over to hijiki_tpu_torch, and locate the in-repo scenes.

Both packages are imported by the tests only (the port never imports jax);
data moves between them as numpy arrays."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

# the twins run many small tensor ops: intra-op threads only spin there, and
# with several test workers they oversubscribe the cores
torch.set_num_threads(1)

def _build_jax_bvh_library():
    """Build hijiki_tpu's native BVH library once per machine, before any
    test asks for it: its loader compiles through one shared ``<so>.tmp``,
    and a test worker that loses that race to another skips every native
    case of tests/test_native_bvh.py. Every worker imports this module when
    it collects the port's tests, before any test runs: the first takes the
    lock and builds, the others wait and find the library there. Where the
    JAX package is absent (the card's machine) there is nothing to build."""
    import fcntl
    import tempfile

    try:
        from hijiki_tpu.accel import native
    except ImportError:
        return
    cache = os.path.join(tempfile.gettempdir(), "hijiki_tpu_native")
    os.makedirs(cache, exist_ok=True)
    with open(os.path.join(cache, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            native.load_library()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


_build_jax_bvh_library()

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MESHBOX = os.path.join(REPO, "scenes", "meshbox", "meshbox.obj")
MESHBOX_SMALL = os.path.join(REPO, "scenes", "meshbox", "meshbox_small.obj")


def port_scene(cs):
    """hijiki_tpu CompiledScene (jax or numpy leaves) -> the port's."""
    from hijiki_tpu_torch.scene.compile import from_reference

    arrays, statics = {}, {}
    for f in dataclasses.fields(cs):
        v = getattr(cs, f.name)
        if f.metadata.get("static"):
            statics[f.name] = v
        elif v is not None:
            arrays[f.name] = np.asarray(v)
    return from_reference(arrays, statics)


def mixed_scene(pkg):
    """The mixed scene of tests/test_megakernel.py:242-289 (quads,
    checkerboard triangles with real UVs, a mirror and a glass sphere),
    built with ``pkg``'s scene model ("hijiki_tpu" or "hijiki_tpu_torch")."""
    import importlib

    m = importlib.import_module(f"{pkg}.scene.model")
    s = m.Scene(camera=m.Camera.cbox_default())
    white = s.add_material(m.Diffuse((0.7, 0.7, 0.7)))
    cb = s.add_material(m.DiffuseCheckerboard((0.9, 0.2, 0.2), 0.25, (0.2, 0.2, 0.9), 0.25))
    mirror = s.add_material(m.Mirror())
    glass = s.add_material(m.Dielectric.clear(1.5))
    light = s.add_material(m.Emissive((10.0, 10.0, 10.0)))
    s.add_object(m.Quad((-2, 0, -2), (4, 0, 0), (0, 0, 4)), white)
    s.add_object(m.Quad((-2, 0, -2), (4, 0, 0), (0, 3, 0)), cb)
    s.add_object(m.Quad((-0.5, 2.8, -0.5), (1, 0, 0), (0, 0, 1)), light)
    s.positions = np.array([[-1.5, 0.01, 1.5], [1.5, 0.01, 1.5], [0.0, 0.01, -1.5]], np.float32)
    s.normals = np.array([[0, 1, 0]] * 3, np.float32)
    s.uvs = np.array([[0, 0], [4, 0], [2, 4]], np.float32)
    s.add_object(m.Triangle((0, 1, 2)), cb)
    s.add_object(m.Sphere((-0.8, 0.5, 0.3), 0.5), mirror)
    s.add_object(m.Sphere((0.8, 0.5, 0.3), 0.5), glass)
    return s


def cuda_device():
    """The CUDA device, or skip the calling test (decided at run time, never
    at import, so every test worker collects the same tests)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the H100: see README)")
    return torch.device("cuda")


def frame_inputs(W, H, jx, jy, mult):
    """Jittered pixel coordinates and per-path seeds as numpy arrays."""
    y, x = np.mgrid[0:H, 0:W]
    px = (x + jx).ravel().astype(np.float32)
    py = (y + jy).ravel().astype(np.float32)
    seeds = (np.arange(W * H) * mult % (1 << 32)).astype(np.uint32)
    return px, py, seeds


def many_emitter_scene(pkg):
    """The mixed scene plus 9 small emitters (spheres, quads and triangles):
    10 emitters in all, past the 8 that sample_emitter unrolls, so NEE takes
    its gather path. Built with ``pkg``'s scene model."""
    import importlib

    m = importlib.import_module(f"{pkg}.scene.model")
    s = mixed_scene(pkg)
    warm = s.add_material(m.Emissive((4.0, 3.0, 2.0)))
    cool = s.add_material(m.Emissive((1.0, 2.0, 5.0)))
    for k in range(3):
        s.add_object(m.Sphere((-1.5 + 1.5 * k, 2.2, -1.2), 0.1), warm)
        s.add_object(m.Quad((-1.6 + 1.4 * k, 2.5, 1.0), (0.3, 0, 0), (0, 0, 0.3)), cool)
    base = len(s.positions)
    tri = np.array([[-0.2, 2.6, 0.0], [0.2, 2.6, 0.0], [0.0, 2.6, 0.3]], np.float32)
    for k in range(3):
        s.positions = np.concatenate([s.positions, tri + np.float32([1.2 * k - 1.2, 0, -0.5])])
        s.normals = np.concatenate([s.normals, np.array([[0, -1, 0]] * 3, np.float32)])
        s.uvs = np.concatenate([s.uvs, np.zeros((3, 2), np.float32)])
        s.add_object(m.Triangle((base + 3 * k, base + 3 * k + 1, base + 3 * k + 2)), warm)
    return s


def scene_pair(name, leaf_size=1):
    """One scene compiled by hijiki_tpu (its defaults: the boxes on) and
    carried to the port: (the JAX device scene, the port's CPU tensor
    scene). ``name``: "meshbox_small" (with the cbox spheres),
    "cornell-glass", "mixed" or "many_emitters"."""
    from hijiki_tpu.scene.compile import compile_scene, scene_to_device

    from hijiki_tpu_torch.scene.compile import to_device

    if name == "meshbox_small":
        from hijiki_tpu.scene.obj import load_obj_scene

        s = load_obj_scene(MESHBOX_SMALL)
        s.put_cbox_spheres()
    elif name == "mixed":
        s = mixed_scene("hijiki_tpu")
    elif name == "many_emitters":
        s = many_emitter_scene("hijiki_tpu")
    else:
        from hijiki_tpu.scene.presets import load_preset

        s = load_preset(name)
    jcs = compile_scene(s, leaf_size=leaf_size)
    return scene_to_device(jcs), to_device(port_scene(jcs), "cpu")


def random_rays(scene, n, seed):
    """``n`` rays from points inside the scene's bounds in random
    directions (numpy, f32): every 7th lane inactive (tmax -3e38), every
    5th with a finite random tmax, the rest tmax = inf."""
    rng = np.random.default_rng(seed)
    box = [x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
           for x in (scene.bvh_aabb_min, scene.bvh_aabb_max)]
    lo, hi = box[0][0], box[1][0]
    o = (lo + (hi - lo) * rng.random((n, 3))).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmin = np.full(n, 1e-4, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    tmax[1::5] = (rng.random(n)[1::5] * 2.0).astype(np.float32)
    tmax[::7] = -3.0e38
    return o, d, tmin, tmax


def t(x):
    """numpy (or jax) array -> CPU tensor (a copy)."""
    return torch.from_numpy(np.array(x))


def sparse_rays(rays, seed, walking=0.01):
    """``rays`` (random_rays' o, d, tmin, tmax) with every lane dead (tmax
    -3e38) but a scattered ``walking`` share, as at a late bounce of the
    sync driver; at least four lanes walk."""
    o, d, tmin, tmax = rays
    rng = np.random.default_rng(seed)
    keep = rng.random(len(tmax)) < walking
    keep[rng.choice(len(tmax), 4, replace=False)] = True
    tmax = np.where(keep, np.where(tmax < 0, np.float32(np.inf), tmax), np.float32(-3.0e38))
    return o, d, tmin, tmax.astype(np.float32)
