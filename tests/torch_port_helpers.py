"""Shared helpers of the tests/test_torch_*.py files: carry a scene compiled
by hijiki_tpu over to hijiki_tpu_torch, and locate the in-repo scenes.

Both packages are imported by the tests only (the port never imports jax);
data moves between them as numpy arrays."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest

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
