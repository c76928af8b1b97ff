"""hijiki_tpu_torch: the PyTorch/CUDA port of hijiki-tpu for NVIDIA Hopper.

The port sits beside the JAX package ``hijiki_tpu`` (the reference it is
tested against) and keeps its module paths and public names, these
top-level ones included. It imports ``torch`` and never ``jax``, and
importing it builds no kernel (they build at their first launch). Quick
start::

    from hijiki_tpu_torch import RenderConfig, Renderer, compile_scene, load_obj_scene
    scene = load_obj_scene("scenes/meshbox/meshbox.obj")   # or load_preset(name)
    scene.put_cbox_spheres()
    r = Renderer(compile_scene(scene), RenderConfig(width=1024, height=1024, spp=8),
                 device="cuda")
    r.render()
    image = r.image()                            # (H, W, 3) float RGB

The CLI: ``python -m hijiki_tpu_torch.cli --help``.
"""

from hijiki_tpu_torch.parallel.multichip import MegaMultiChipRenderer, MultiChipRenderer
from hijiki_tpu_torch.parallel.multihost import MultiHostRenderer
from hijiki_tpu_torch.render.renderer import RenderConfig, Renderer, render_sweep
from hijiki_tpu_torch.scene.compile import CompiledScene, compile_scene
from hijiki_tpu_torch.scene.obj import load_obj_scene
from hijiki_tpu_torch.scene.presets import load_preset

__all__ = [
    "CompiledScene",
    "MegaMultiChipRenderer",
    "MultiChipRenderer",
    "MultiHostRenderer",
    "RenderConfig",
    "Renderer",
    "compile_scene",
    "load_obj_scene",
    "load_preset",
    "render_sweep",
]
