"""The slices end to end: the port's Renderer (mega driver, unchained and
chained sweeps; the sync and wavefront drivers; fixed albedo; radius-3
reconstruction) against hijiki_tpu's Renderer on the same compiled scene
and seed, chained against unchained, and checkpoint/resume.

Film tolerance: per pixel rtol/atol 2e-3 on >= 90% of pixels, the image
mean within 1%. A path that reroutes (the <= 0.5% silhouette/t-tie class of
test_torch_megakernel.py) changes its pixel's sample, and the 5x5
reconstruction spreads that sample to up to 25 film pixels, so a few
divergent paths per sweep can move a few percent of the pixels. The sync
and wavefront films measured 99.3% of pixels within rtol 1e-4 / atol 2e-4
and means within 6e-5 relative at 32x32, 2 spp."""

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


def test_renderer_chained_matches_tpu_renderer():
    """chain_sweeps=2 in both packages (one chained chunk of 2 sweeps): the
    film bounds of the unchained comparison above."""
    s = j_load(MESHBOX_SMALL)
    s.put_cbox_spheres()
    jcs = j_compile(s, shadow_vis_boxes=False)
    cfg = dict(width=32, height=32, spp=2, seed=3, chain_sweeps=2, max_bounces=24)
    jr = JRenderer(jcs, JConfig(driver="mega", **cfg))
    jm = jr.render()
    r = Renderer(port_scene(jcs), RenderConfig(**cfg), device="cpu")
    m = r.render()
    a, b = np.asarray(jr.film), r.film.numpy()
    close = np.isclose(a, b, rtol=2e-3, atol=2e-3).all(-1)
    assert close.mean() >= 0.90, f"only {close.mean():.1%} of film pixels agree"
    np.testing.assert_allclose(b[..., :3].mean(), a[..., :3].mean(), rtol=1e-2)
    assert m["chain_chunk_sweeps"] == jm["chain_chunk_sweeps"] == 2
    assert m["wave_overflow"] == 0 and jm["wave_overflow"] == 0


def test_renderer_chained_matches_unchained():
    """tests/test_render.py:252-284: chaining is estimator-exact per (pixel,
    sweep) sample, so the films differ only by the order of the film adds
    (a chunk's deltas are summed before the film add)."""
    cs = _port_scene()
    cfg = dict(width=64, height=64, spp=3, block_size=64, seed=11, max_bounces=8)
    plain = Renderer(cs, RenderConfig(**cfg, chain_sweeps=1), device="cpu")
    plain.render()
    chained = Renderer(cs, RenderConfig(**cfg, chain_sweeps=2), device="cpu")
    m = chained.render()
    assert m["chain_chunk_sweeps"] == 2 and len(m["sweep_marks"]) == 2
    a, b = plain.film.numpy(), chained.film.numpy()
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert a.mean() > 0.01


def test_preview_fires_across_chained_chunks(tmp_path):
    """Chunks of 2 advance sweeps_done to 2 and 4; an interval of 3 is
    crossed once, though no sweeps_done is a multiple of it."""
    png = tmp_path / "prev.png"
    cfg = RenderConfig(width=32, height=32, spp=4, block_size=64, seed=2, max_bounces=4,
                       chain_sweeps=2, preview_interval=3, preview_path=str(png))
    Renderer(_port_scene(), cfg, device="cpu").render()
    assert png.exists() and png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("size,chain,mb", [(32, 1, 4), (64, 2, 4), (64, 2, 16), (32, 1, 1000)])
def test_overflow_zero_matrix(size, chain, mb):
    """tests/test_render.py:384-403: no default capacity drops a path,
    chained or not, max_bounces <= chain_cap included."""
    import warnings

    cfg = RenderConfig(width=size, height=size, spp=2, block_size=64, seed=3,
                       max_bounces=mb, chain_sweeps=chain)
    r = Renderer(_port_scene(), cfg, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r.render()
    assert r.metrics["wave_overflow"] == 0 and r.metrics["overflow_retried"] == 0


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


@pytest.mark.parametrize("kw", [
    dict(driver="sync"),
    dict(driver="sync", fixed_albedo=True),
    dict(driver="sync", reconstruction_radius=3),
    dict(driver="wavefront", wavefront_lanes=256),
    dict(driver="wavefront", wavefront_lanes=512, sort_lanes=True),
    dict(driver="mega", fixed_albedo=True),
], ids=["sync", "sync-albedo", "sync-radius3", "wavefront", "wavefront-sorted", "mega-albedo"])
def test_drivers_match_tpu_renderer(kw):
    """Each driver and option against the JAX Renderer with the same
    config (the mega driver with fixed albedo runs unchained, as in JAX)."""
    s = j_load(MESHBOX_SMALL)
    s.put_cbox_spheres()
    jcs = j_compile(s, shadow_vis_boxes=False)
    cfg = dict(width=32, height=32, spp=2, block_size=64, seed=3, max_bounces=24, **kw)
    jr = JRenderer(jcs, JConfig(**cfg))
    jr.render()
    r = Renderer(port_scene(jcs), RenderConfig(**cfg), device="cpu")
    m = r.render()
    a, b = np.asarray(jr.film), r.film.numpy()
    close = np.isclose(a, b, rtol=2e-3, atol=2e-3).all(-1)
    assert close.mean() >= 0.90, f"only {close.mean():.1%} of film pixels agree"
    np.testing.assert_allclose(b[..., :3].mean(), a[..., :3].mean(), rtol=1e-2)
    assert np.isfinite(r.image()).all() and m["wave_overflow"] == 0
    assert m["chain_chunk_sweeps"] == 1
    if kw["driver"] != "mega":
        np.testing.assert_allclose(b[..., :3].mean(), a[..., :3].mean(), rtol=1e-3)
        assert 0 < m["iterations_last_sweep"] and "mean_path_length" not in m


def test_fixed_albedo_changes_the_film():
    """The albedo feature term reweights the reconstruction: the radiance
    traced is the same, the film is not."""
    cs = _port_scene()
    cfg = dict(width=32, height=32, spp=1, block_size=64, seed=4, max_bounces=8, driver="sync")
    plain = Renderer(cs, RenderConfig(**cfg), device="cpu")
    plain.render()
    alb = Renderer(cs, RenderConfig(**cfg, fixed_albedo=True), device="cpu")
    alb.render()
    assert not torch.equal(plain.film, alb.film)
    assert abs(float(plain.film[..., 3].mean() - alb.film[..., 3].mean())) > 1e-3


@pytest.mark.parametrize("driver", ["sync", "wavefront"])
def test_checkpoint_resume_bit_equal(driver, tmp_path):
    """Saved at sweep 2 of 4 from the progress callback and resumed in a new
    Renderer: the film equals the uninterrupted render bit for bit."""
    cs = _port_scene()
    cfg = RenderConfig(width=32, height=32, spp=4, block_size=64, seed=6, max_bounces=6,
                       driver=driver, wavefront_lanes=512)
    ck = str(tmp_path / "ck.npz")
    full = Renderer(cs, cfg, device="cpu")

    def save_at_2(done, total):
        if done == 2:
            full.save_checkpoint(ck)

    full.render(progress=save_at_2)
    resumed = Renderer.resume_checkpoint(cs, ck, cfg, device="cpu")
    assert resumed.sweeps_done == 2
    m = resumed.render()
    assert m["primary_rays"] == 32 * 32 * 2
    assert torch.equal(resumed.film, full.film)
    with pytest.raises(ValueError, match="driver"):
        Renderer.resume_checkpoint(cs, ck, RenderConfig(width=32, height=32, spp=4, block_size=64,
                                                        seed=6, max_bounces=6), device="cpu")


@pytest.mark.parametrize("field,value", [
    ("mega_trunk", 5), ("mega_groups", 2),
    ("mega_window", 2), ("mega_packet", 1024), ("spec_resolve", 1),
])
def test_unported_config_refused(field, value):
    """The walker knobs the port once refused are accepted and leave the
    film as it is bit for bit."""
    cfg = dict(width=64, height=64, spp=1, block_size=64, max_bounces=6)
    plain = Renderer(_port_scene(), RenderConfig(**cfg), device="cpu")
    knob = Renderer(_port_scene(), RenderConfig(**cfg, **{field: value}), device="cpu")
    knob.render()
    plain.render()
    assert torch.equal(knob.film.view(torch.int32), plain.film.view(torch.int32))


def test_unknown_driver_or_traversal_refused():
    for kw in (dict(driver="bulk"), dict(driver="sync", traversal="octree")):
        with pytest.raises(ValueError, match="unknown"):
            Renderer(_port_scene(), RenderConfig(width=16, height=16, **kw), device="cpu")


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


@pytest.mark.parametrize("requested,env", [(0, None), (1, None), (-1, None), (0, "1"), (0, "-1"),
                                           (-1, "1"), (1, "-1")])
def test_resolve_shadow_tbl_as_jax(requested, env, monkeypatch):
    """mega_shadow resolves as JAX's resolve_shadow_tbl does: 0 is auto and
    off, > 0 on, < 0 off, HIJIKI_SHADOW_TBL overriding the auto choice."""
    from hijiki_tpu.render.renderer import resolve_shadow_tbl as j_resolve
    from hijiki_tpu_torch.render.renderer import resolve_shadow_tbl

    if env is None:
        monkeypatch.delenv("HIJIKI_SHADOW_TBL", raising=False)
    else:
        monkeypatch.setenv("HIJIKI_SHADOW_TBL", env)
    assert resolve_shadow_tbl(requested) == j_resolve(requested, False, None)


@pytest.mark.parametrize("chain", [1, 2])
def test_mega_shadow_keeps_the_film(chain):
    """The renderer with the dedicated shadow table (mega_shadow=1), chained
    or not: the film bit-equal to the default render, fewer rows visited;
    on a scene compiled without a table it raises."""
    cs = _port_scene()
    cfg = dict(width=32, height=32, spp=2, seed=4, max_bounces=12, chain_sweeps=chain)
    a = Renderer(cs, RenderConfig(**cfg), device="cpu")
    ma = a.render()
    b = Renderer(cs, RenderConfig(**cfg, mega_shadow=1), device="cpu")
    mb = b.render()
    assert torch.equal(a.film, b.film)
    assert mb["rows_visited_last_sweep"] < ma["rows_visited_last_sweep"]
    s = load_obj_scene(MESHBOX_SMALL)
    s.put_cbox_spheres()
    packed = Renderer(compile_scene(s, packed_leaf=4), RenderConfig(**cfg, mega_shadow=1),
                      device="cpu")
    with pytest.raises(ValueError, match="dedicated shadow table"):
        packed.render()
