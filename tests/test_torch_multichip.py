"""hijiki_tpu_torch.parallel.multichip on the CPU: the sharded renderers
against the port's single-device Renderer and against hijiki_tpu's sharded
renderers (the conftest's virtual 8-device CPU mesh; the port's devices
are entries of the CPU, one named several times, as two bands share a card).

Bounds. Against the port's single film, on every pixel: the sync
MultiChipRenderer at rtol 5e-4 / atol 5e-5, the MegaMultiChipRenderer at
rtol 1e-4 / atol 1e-5 (tests/test_multichip.py's bounds; the films differ
only in the order of their float sums), the overflow settle bit for bit.
Against JAX's sharded film, at the same bounds, on every pixel where the
port's single film agrees with it at those bounds, and those must be >=
98% of the pixels: the other ~1% are the port-vs-JAX reroute class of the
single-device films (the silhouette/t-tie class of test_torch_megakernel.py
and test_torch_renderer.py, measured 99.1-99.2% agreeing here), which no
sharding moves. The reconstruction with a sample weight: rtol 1e-5 / atol
1e-6, as test_torch_reconstruct.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hijiki_tpu.parallel.multichip import (
    MegaMultiChipRenderer as JMegaMultiChipRenderer,
    MultiChipRenderer as JMultiChipRenderer,
)
from hijiki_tpu.render.pallas_reconstruct import reconstruct_pallas
from hijiki_tpu.render.reconstruct import reconstruct_sweep as j_reconstruct_sweep
from hijiki_tpu.render.renderer import RenderConfig as JConfig
from hijiki_tpu.scene.compile import compile_scene as j_compile
from hijiki_tpu.scene.obj import load_obj_scene as j_load
from hijiki_tpu_torch.parallel.multichip import (
    MegaMultiChipRenderer, MultiChipRenderer, resolve_devices,
)
from hijiki_tpu_torch.render import pallas_reconstruct as prc
from hijiki_tpu_torch.render.blocks import per_pixel_seeds_device
from hijiki_tpu_torch.render.reconstruct import reconstruct_sweep
from hijiki_tpu_torch.render.renderer import RenderConfig, Renderer
from torch_port_helpers import MESHBOX_SMALL, port_scene

SYNC, MEGA = dict(rtol=5e-4, atol=5e-5), dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def scenes():
    s = j_load(MESHBOX_SMALL)
    s.put_cbox_spheres()
    jcs = j_compile(s, shadow_vis_boxes=False)
    return jcs, port_scene(jcs)


_single = {}


def single_film(cs, cfg):
    """The port's single-device film of ``cfg`` (rendered once a config)."""
    if cfg not in _single:
        r = Renderer(cs, cfg, device="cpu")
        r.render()
        _single[cfg] = r.film.numpy()
    return _single[cfg]


def agree_with_jax(port_multi, port_single, jax_multi, bounds):
    close = np.isclose(port_single, jax_multi, **bounds).all(-1)
    assert close.mean() >= 0.98, f"single films agree with JAX on {close.mean():.2%} only"
    multi = np.isclose(port_multi, jax_multi, **bounds).all(-1)
    assert multi[close].all(), f"{int((~multi & close).sum())} pixels moved by the sharding"


@pytest.mark.parametrize("W,H,ndev,seed,max_bounces", [
    (128, 128, 2, 5, 8),
    (128, 128, 4, 5, 8),
    (192, 128, 4, 9, 6),  # 3x2 = 6 blocks over 4 devices: 2 dummy blocks
])
def test_multichip_matches_single_and_jax(scenes, W, H, ndev, seed, max_bounces):
    jcs, cs = scenes
    kw = dict(width=W, height=H, spp=1, block_size=64, seed=seed, max_bounces=max_bounces)
    cfg = RenderConfig(driver="sync", **kw)
    r = MultiChipRenderer(cs, cfg, num_devices=ndev, device="cpu")
    m = r.render()
    assert m["devices"] == ndev and r.n_real_blocks == (W // 64) * (H // 64)
    assert len(r.block_origins) % ndev == 0
    film, single = r.film.numpy(), single_film(cs, cfg)
    np.testing.assert_allclose(film, single, **SYNC)
    jr = JMultiChipRenderer(jcs, JConfig(**kw), num_devices=ndev)
    jr.render()
    agree_with_jax(film, single, np.asarray(jr.film), SYNC)


def test_mega_multichip_matches_single_and_jax(scenes):
    """Two row bands of 64 rows (the smallest frame JAX's band rule takes at
    block 64), one sweep: K1/K2's twins and the weighted K3 twin on each
    band's extended canvas, then the halo exchange."""
    jcs, cs = scenes
    kw = dict(width=32, height=128, spp=1, block_size=64, seed=5, max_bounces=8)
    cfg = RenderConfig(driver="mega", **kw)
    r = MegaMultiChipRenderer(cs, cfg, devices=["cpu", "cpu"])
    m = r.render()
    assert m["devices"] == 2 and m["wave_overflow"] == 0
    film, single = r.film.numpy(), single_film(cs, cfg)
    np.testing.assert_allclose(film, single, **MEGA)
    # the bands' seam: the rows that take the band above's spill differ
    # from the single film only by the order of their sums
    assert not np.array_equal(film[64:66], single[64:66])
    jr = JMegaMultiChipRenderer(jcs, JConfig(driver="mega", **kw), num_devices=2, interpret=True)
    jr.render()
    agree_with_jax(film, single, np.asarray(jr.film), MEGA)


def test_mega_multichip_chained_matches_single_chained(scenes):
    """chain_sweeps=2: each band traces its chunk with render_waves_chained
    and reconstructs both sweeps in one K3 call (JAX's sharded S > 1 branch
    never runs on the CPU, so it has no film to compare)."""
    _, cs = scenes
    cfg = RenderConfig(width=32, height=128, spp=2, block_size=64, seed=5, max_bounces=24,
                       driver="mega", chain_sweeps=2)
    r = MegaMultiChipRenderer(cs, cfg, devices=["cpu", "cpu"])
    m = r.render()
    assert m["chain_chunk_sweeps"] == 2 and m["wave_overflow"] == 0
    np.testing.assert_allclose(r.film.numpy(), single_film(cs, cfg), **MEGA)


@pytest.mark.parametrize("chain", [1, 2])
def test_mega_multichip_overflow_settle(scenes, chain):
    """A capacity that drops paths in some band re-renders every chunk at
    full capacity on every band: the film equals the run that never
    overflowed, bit for bit (tests/test_multichip.py:83-114), unchained
    (shrink 9999 clamps the first resume to one 1024-lane tile; ~5.5% of a
    band's 32,768 paths live past bounce 5) and with chunks of two sweeps
    (chain cap 2: most samples park)."""
    _, cs = scenes
    base = dict(width=256 if chain == 1 else 64, height=256 if chain == 1 else 128,
                spp=2 if chain > 1 else 1,
                block_size=64, seed=11, driver="mega", max_bounces=6 if chain == 1 else 24,
                chain_sweeps=chain, mega_chain_cap=2 if chain > 1 else 0)
    r = MegaMultiChipRenderer(cs, RenderConfig(phase_shrink=(9999,), **base), num_devices=2,
                              device="cpu")
    with pytest.warns(UserWarning, match="full capacity"):
        m = r.render()
    good = MegaMultiChipRenderer(cs, RenderConfig(phase_shrink=(1,) * 8, **base),
                                 num_devices=2, device="cpu")
    mg = good.render()
    assert m["overflow_retried"] > 0 and m["wave_overflow"] == 0
    assert mg["overflow_retried"] == 0
    assert torch.equal(r.film, good.film)


def test_band_errors(scenes):
    """JAX's two errors (multichip.py:318-326), raised as JAX raises them."""
    _, cs = scenes
    cfg = dict(width=32, block_size=64, driver="mega")
    with pytest.raises(ValueError, match="divide evenly into device bands"):
        MegaMultiChipRenderer(cs, RenderConfig(height=128, **cfg), num_devices=3, device="cpu")
    with pytest.raises(ValueError, match="band height 64 must be a multiple of block_size 128"):
        MegaMultiChipRenderer(cs, RenderConfig(height=128, **dict(cfg, block_size=128)),
                              num_devices=2, device="cpu")


def test_devices_beyond_the_cards_raise(scenes):
    _, cs = scenes
    n = torch.cuda.device_count()
    cfg = RenderConfig(width=32, height=128, block_size=64, driver="mega")
    with pytest.raises(ValueError, match="CUDA devices"):
        MegaMultiChipRenderer(cs, cfg, num_devices=n + 1)
    with pytest.raises(ValueError, match="CUDA devices"):
        MultiChipRenderer(cs, RenderConfig(driver="sync"), devices=[f"cuda:{n}"])
    with pytest.raises(ValueError, match="CUDA devices"):
        resolve_devices(n + 2)
    assert resolve_devices(3, device="cpu") == [torch.device("cpu")] * 3


def test_per_pixel_seeds_of_a_band():
    """A band's per-pixel seeds (row0) are the full frame's for its rows,
    also for a band that starts mid-block."""
    rng = np.random.default_rng(3)
    W, H, B = 200, 320, 64
    bs = rng.integers(0, 1 << 32, size=(5, 4), dtype=np.uint32)
    full = per_pixel_seeds_device(W, H, B, bs)
    for row0, rows in ((0, 64), (128, 128), (160, 96), (7, 50)):
        assert torch.equal(per_pixel_seeds_device(W, rows, B, bs, row0=row0),
                           full[row0:row0 + rows])


@pytest.mark.parametrize("nan_frac", [0.0, 0.02])
def test_weighted_reconstruction_matches_jax(nan_frac):
    """reconstruct_sweep(sample_weight=) and the K3 wrapper's plain version
    on a band canvas zero-padded by B rows, weight 0 there, against JAX's
    reconstruct_sweep and reconstruct_pallas (interpret) with that weight."""
    rng = np.random.default_rng(11)
    band, W, B = 64, 96, 64
    pad = lambda a: np.pad(a, [(B, B)] + [(0, 0)] * (a.ndim - 1))
    color = (rng.random((band, W, 3)) * 3.0).astype(np.float32)
    color[rng.random((band, W)) < nan_frac] = np.nan
    normal = rng.standard_normal((band, W, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    color, normal = pad(color), pad(normal)
    weight = pad(np.ones((band, W), np.float32))
    so = rng.random(2).astype(np.float32)
    j = lambda a: jnp.asarray(a)
    want_xla = np.asarray(j_reconstruct_sweep(j(color), j(normal), j(np.zeros_like(color)), j(so),
                                              block_size=B, sample_weight=j(weight)))
    want_pallas = np.asarray(reconstruct_pallas(j(color), j(normal), j(so), j(weight),
                                                block_size=B, interpret=True))
    t = torch.from_numpy
    got = reconstruct_sweep(t(color), t(normal), torch.zeros_like(t(color)), so, block_size=B,
                            sample_weight=t(weight)).numpy()
    got_k3 = prc.reconstruct(t(color), t(normal), so, block_size=B, sample_weight=t(weight)).numpy()
    for g in (got, got_k3):
        np.testing.assert_allclose(g, want_xla, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g, want_pallas, rtol=1e-5, atol=1e-6)
    # the padding holds no samples: nothing but the R rows of spill below
    # the band reaches past it, and weight 1 everywhere is the unweighted K3
    assert not got[:B].any() and not got[B + band + prc.R:].any() and got[B + band].any()
    ones = torch.ones(color.shape[:2])
    assert torch.equal(prc.reconstruct(t(color), t(normal), so, block_size=B, sample_weight=ones),
                       prc.reconstruct(t(color), t(normal), so, block_size=B))


@pytest.mark.parametrize("direction", ["single-to-bands", "bands-to-single"])
def test_resume_across_device_counts(scenes, tmp_path, direction):
    """The checkpoint holds the gathered film in the single Renderer's
    format, so a render saved on one device resumes on two bands and back
    (hijiki_tpu/cli.py:266-272)."""
    _, cs = scenes
    base = dict(width=32, height=128, block_size=64, seed=4, max_bounces=8, driver="mega")
    first, then = (Renderer, MegaMultiChipRenderer)
    if direction == "bands-to-single":
        first, then = then, first
    kw = lambda cls: dict(devices=["cpu", "cpu"]) if cls is MegaMultiChipRenderer else {}
    r = first(cs, RenderConfig(spp=2, **base), device="cpu", **kw(first))
    r.render()
    ck = str(tmp_path / "ck.npz")
    r.save_checkpoint(ck)
    resumed = then.resume_checkpoint(cs, ck, RenderConfig(spp=4, **base), device="cpu", **kw(then))
    assert resumed.sweeps_done == 2
    m = resumed.render()
    assert m["primary_rays"] == 32 * 128 * 2
    np.testing.assert_allclose(resumed.film.numpy(), single_film(cs, RenderConfig(spp=4, **base)),
                               **MEGA)


def test_multichip_resumed_metrics_count_traced_sweeps(scenes):
    """tests/test_multichip.py:176-188: after a resume the rate counts only
    the sweeps traced in this call."""
    _, cs = scenes
    cfg = RenderConfig(width=128, height=64, spp=4, block_size=64, seed=3, max_bounces=6,
                       driver="sync")
    r = MultiChipRenderer(cs, cfg, num_devices=2, device="cpu")
    r.sweeps_done = 3
    for s in range(3):
        r.scheduler.sweep(s)  # the scheduler replay, as resume_checkpoint does
    assert r.render()["primary_rays"] == 128 * 64


@pytest.mark.parametrize("chain", [1, 2])
def test_mega_multichip_shadow_table_and_boxes(chain):
    """The bands launch with the boxes of a default compile and, with
    mega_shadow=1, with the dedicated shadow table: the film bit-equal to the
    bands' film without either (the boxes and the table skip or reroute
    shadow walks only)."""
    from hijiki_tpu_torch.scene.compile import compile_scene
    from hijiki_tpu_torch.scene.obj import load_obj_scene

    s = load_obj_scene(MESHBOX_SMALL)
    s.put_cbox_spheres()
    base = dict(width=32, height=128, spp=2, block_size=64, seed=5, max_bounces=16,
                driver="mega", chain_sweeps=chain)
    films = []
    for boxes, shadow in ((False, 0), (True, 0), (True, 1)):
        r = MegaMultiChipRenderer(compile_scene(s, shadow_vis_boxes=boxes),
                                  RenderConfig(**base, mega_shadow=shadow), devices=["cpu", "cpu"])
        m = r.render()
        films.append((r.film.clone(), m["rows_visited_last_sweep"]))
    assert all(torch.equal(f, films[0][0]) for f, _ in films)
    assert films[2][1] < films[1][1] < films[0][1]
