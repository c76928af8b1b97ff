"""The slice end to end: the port's Renderer (mega driver, unchained sweeps)
against hijiki_tpu's Renderer on the same compiled scene and seed.

Film tolerance: per pixel rtol/atol 2e-3 on >= 90% of pixels, the image
mean within 1%. A path that reroutes (the <= 0.5% silhouette/t-tie class of
test_torch_megakernel.py) changes its pixel's sample, and the 5x5
reconstruction spreads that sample to up to 25 film pixels, so a few
divergent paths per sweep can move a few percent of the pixels."""

import numpy as np
import pytest
import torch

from hijiki_tpu.render.renderer import RenderConfig as JConfig, Renderer as JRenderer
from hijiki_tpu.scene.compile import compile_scene as j_compile
from hijiki_tpu.scene.obj import load_obj_scene as j_load
from hijiki_tpu_torch.render.renderer import RenderConfig, Renderer
from hijiki_tpu_torch.scene.compile import compile_scene
from hijiki_tpu_torch.scene.obj import load_obj_scene
from hijiki_tpu_torch.utils.exr import read_exr
from torch_port_helpers import MESHBOX_SMALL, port_scene


def _port_scene():
    s = load_obj_scene(MESHBOX_SMALL)
    s.put_cbox_spheres()
    return compile_scene(s)


def test_renderer_matches_tpu_renderer():
    s = j_load(MESHBOX_SMALL)
    s.put_cbox_spheres()
    jcs = j_compile(s, shadow_vis_boxes=False)
    jr = JRenderer(jcs, JConfig(width=32, height=32, spp=2, driver="mega", seed=3))
    jm = jr.render()
    r = Renderer(port_scene(jcs), RenderConfig(width=32, height=32, spp=2, seed=3), device="cpu")
    m = r.render()
    a, b = np.asarray(jr.film), r.film.numpy()
    close = np.isclose(a, b, rtol=2e-3, atol=2e-3).all(-1)
    assert close.mean() >= 0.90, f"only {close.mean():.1%} of film pixels agree"
    np.testing.assert_allclose(b[..., :3].mean(), a[..., :3].mean(), rtol=1e-2)
    assert np.isfinite(r.image()).all()
    assert m["wave_overflow"] == 0 and jm["wave_overflow"] == 0
    # the same metric keys (plus Mrays/s)
    assert set(jm) <= set(m) and "mrays_per_second" in m
    assert m["primary_rays"] == jm["primary_rays"] == 32 * 32 * 2
    assert abs(m["mean_path_length"] - jm["mean_path_length"]) < 0.05


def test_overflow_retry_keeps_film_unbiased():
    """A phase capacity too small for the survivors drops paths; the
    renderer re-renders those sweeps at full capacity with the same seeds,
    so the film equals an unconstrained render bit for bit."""
    cs = _port_scene()
    cfg = dict(width=256, height=256, spp=1, seed=11, max_bounces=12)
    tight = Renderer(cs, RenderConfig(**cfg, phase_shrink=(64, 4, 4)), device="cpu")
    with pytest.warns(UserWarning, match="phase capacity"):
        m = tight.render()
    assert m["overflow_retried"] > 0 and m["wave_overflow"] == 0
    full = Renderer(cs, RenderConfig(**cfg, phase_shrink=(1, 1, 1)), device="cpu")
    full.render()
    np.testing.assert_array_equal(tight.film.numpy(), full.film.numpy())


@pytest.mark.parametrize("field,value", [
    ("driver", "sync"), ("chain_sweeps", 8), ("sort_lanes", True),
    ("fixed_albedo", True), ("mega_packet", 1024), ("reconstruction_radius", 3),
])
def test_unported_config_refused(field, value):
    with pytest.raises(NotImplementedError, match="not ported"):
        Renderer(_port_scene(), RenderConfig(width=64, height=64, **{field: value}), device="cpu")


def test_save_exr_roundtrip(tmp_path):
    r = Renderer(_port_scene(), RenderConfig(width=16, height=16, spp=1, max_bounces=8), device="cpu")
    r.render()
    r.save_exr(str(tmp_path / "o.exr"))
    np.testing.assert_array_equal(read_exr(str(tmp_path / "o.exr")), r.image())


def test_cuda_renderer_requires_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(_port_scene(), RenderConfig(width=16, height=16), device="cuda")
