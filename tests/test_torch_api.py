"""The port's top-level API: the JAX package's names, from the port's own
modules, and the package docstring's quick start run on the CPU."""

import subprocess
import sys

import numpy as np
import pytest

import hijiki_tpu
import hijiki_tpu_torch
from torch_port_helpers import MESHBOX_SMALL, REPO


def test_top_level_names_are_the_jax_packages():
    assert hijiki_tpu_torch.__all__ == hijiki_tpu.__all__


@pytest.mark.parametrize("name", hijiki_tpu.__all__)
def test_each_name_resolves_to_the_ports_module(name):
    """Each name is the object of the port's module that JAX's name comes
    from (the same module path under hijiki_tpu_torch)."""
    import importlib

    want = getattr(hijiki_tpu, name)
    port_module = want.__module__.replace("hijiki_tpu.", "hijiki_tpu_torch.", 1)
    got = getattr(hijiki_tpu_torch, name)
    assert got is getattr(importlib.import_module(port_module), name)
    assert got.__module__.startswith("hijiki_tpu_torch.")


def test_import_builds_no_kernel_and_no_jax():
    """A fresh interpreter: importing the package and taking every top-level
    name loads no kernel library and no jax."""
    code = (
        "import sys\n"
        "from hijiki_tpu_torch import *\n"
        "from hijiki_tpu_torch.utils import build\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'hijiki_tpu.'))]\n"
        "sys.exit(1 if bad or build._loaded else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_quick_start_on_the_cpu():
    """The docstring's quick start through the top-level imports, at 16² x
    1 spp on the small meshbox, on the CPU."""
    from hijiki_tpu_torch import RenderConfig, Renderer, compile_scene, load_obj_scene

    scene = load_obj_scene(MESHBOX_SMALL)
    scene.put_cbox_spheres()
    r = Renderer(compile_scene(scene), RenderConfig(width=16, height=16, spp=1), device="cpu")
    r.render()
    image = r.image()
    assert image.shape == (16, 16, 3) and np.isfinite(image).all()
    assert (image >= 0).all() and image.max() > 0
