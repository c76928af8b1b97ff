"""hijiki_tpu_torch: the PyTorch/CUDA port of hijiki-tpu for NVIDIA Hopper.

The port sits beside the JAX package ``hijiki_tpu`` (the reference it is
tested against) and keeps its module paths and public names. It imports
``torch`` and never ``jax``. Quick start::

    from hijiki_tpu_torch.scene.obj import load_obj_scene
    from hijiki_tpu_torch.scene.compile import compile_scene
    from hijiki_tpu_torch.render.renderer import RenderConfig, Renderer
    scene = load_obj_scene("scenes/meshbox/meshbox.obj")
    scene.put_cbox_spheres()
    r = Renderer(compile_scene(scene), RenderConfig(width=1024, height=1024, spp=8),
                 device="cuda")
    r.render()
    image = r.image()                            # (H, W, 3) float RGB

The CLI: ``python -m hijiki_tpu_torch.cli --help``.
"""
