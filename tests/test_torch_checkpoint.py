"""The chained Renderer's overflow invariant and checkpoint/resume
(tests/test_render.py:406-474 and the JAX Renderer's save_checkpoint /
resume_checkpoint), on the CPU twins."""

import warnings

import numpy as np
import pytest

from hijiki_tpu_torch.render.renderer import RenderConfig, Renderer
from hijiki_tpu_torch.scene.compile import compile_scene
from hijiki_tpu_torch.scene.obj import load_obj_scene
from torch_port_helpers import MESHBOX_SMALL

# chained chunks with a tiny in-kernel cap: most samples park, and shrink
# 9999 clamps the resume capacity to one 1024-lane tile, so paths drop
BAD = dict(block_size=64, seed=11, max_bounces=16, mega_chain_cap=2, phase_shrink=(9999,))
GOOD = dict(BAD, phase_shrink=(1,) * 8)


@pytest.fixture(scope="module")
def cs():
    s = load_obj_scene(MESHBOX_SMALL)
    s.put_cbox_spheres()
    return compile_scene(s)


def test_overflow_retry_unbiased(cs):
    """A chained chunk that drops paths is re-rendered at full capacity: the
    film is bit-equal to a run whose capacities never overflowed."""
    size = dict(width=64, height=32, spp=8, chain_sweeps=8)
    r = Renderer(cs, RenderConfig(**size, **BAD), device="cpu")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        r.render()
    assert any("re-rendering" in str(x.message) and "full capacity" in str(x.message) for x in w)
    assert r.metrics["overflow_retried"] > 0 and r.metrics["wave_overflow"] == 0
    r2 = Renderer(cs, RenderConfig(**size, **GOOD), device="cpu")
    r2.render()
    assert r2.metrics["overflow_retried"] == 0
    np.testing.assert_array_equal(r.film.numpy(), r2.film.numpy())


def test_checkpoint_never_persists_biased_film(cs, tmp_path):
    """A mid-render checkpoint (from the progress callback, as the CLI's
    --checkpoint-interval saves) settles pending overflow first."""
    path = str(tmp_path / "ck.npz")
    r = Renderer(cs, RenderConfig(width=32, height=32, spp=4, chain_sweeps=2, **BAD),
                 device="cpu")
    saved_at = []

    def progress(done, total):
        if done == 2 and not saved_at:
            r.save_checkpoint(path)
            saved_at.append(done)

    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        r.render(progress=progress)
    assert saved_at == [2] and r.metrics["overflow_retried"] > 0
    good = Renderer(cs, RenderConfig(width=32, height=32, spp=2, chain_sweeps=2, **GOOD),
                    device="cpu")
    good.render()
    np.testing.assert_array_equal(np.load(path)["film"], good.film.numpy())


def test_resume_equals_uninterrupted(cs, tmp_path):
    """Save mid-render, resume in a new Renderer: the same chunks, seeds and
    film adds as the uninterrupted render, so the films are bit-equal."""
    path = str(tmp_path / "ck")  # saved at exactly this path (no ".npz")
    cfg = RenderConfig(width=32, height=32, spp=4, chain_sweeps=2, block_size=64, seed=7,
                       max_bounces=12, phase_shrink=(2,))
    full = Renderer(cs, cfg, device="cpu")

    def progress(done, total):
        if done == 2:
            full.save_checkpoint(path)

    full.render(progress=progress)
    r = Renderer.resume_checkpoint(cs, path, cfg, device="cpu")
    assert r.sweeps_done == 2 and r.config.phase_shrink == (2,)
    m = r.render()
    assert m["primary_rays"] == 32 * 32 * 2  # only this call's sweeps
    np.testing.assert_array_equal(r.film.numpy(), full.film.numpy())
    # without a config the saved one is used, its tuple restored
    assert Renderer.resume_checkpoint(cs, path, device="cpu").config == cfg


@pytest.mark.parametrize("field,value", [
    ("width", 48), ("seed", 8), ("max_bounces", 13), ("block_size", 128),
])
def test_resume_conflicting_fields_raise(cs, tmp_path, field, value):
    cfg = RenderConfig(width=32, height=32, spp=1, block_size=64, seed=7, max_bounces=12)
    r = Renderer(cs, cfg, device="cpu")
    path = str(tmp_path / "c.npz")
    r.save_checkpoint(path)
    other = RenderConfig(**{**cfg.__dict__, field: value, "spp": 4})
    with pytest.raises(ValueError, match=field):
        Renderer.resume_checkpoint(cs, path, other, device="cpu")
    # spp may change: the extra sweeps render
    assert Renderer.resume_checkpoint(cs, path, RenderConfig(**{**cfg.__dict__, "spp": 4}),
                                      device="cpu").sweeps_done == 0
