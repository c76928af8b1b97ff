"""The hand-written CUDA kernels against their plain twins, on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA card.
This file imports neither jax nor hijiki_tpu, so it also runs where only
the port is installed (the H100 machine):

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -p no:cacheprovider

Bounds: K3 rtol 1e-5 / atol 1e-6 (expf ULPs); K1/K2/K4/K5 RNG state
bit-equal and radiance within 2e-3 on >= 99.5% of paths (built with
--fmad=false, the kernels round like the twin, which measured them
bit-equal); the chained driver bit-equal per sweep to separate sweeps;
K6 bit-equal to its twin on every channel of every ray, so the sync
driver's film is the same bit for bit whichever walk it runs; K8
(sort_tiles) bit-equal to its plain version; the lane-sorted K1/K2/K5 (K7
inside) bit-equal to the unsorted kernels on every output (a pure
permutation of whole paths)."""

import numpy as np
import pytest
import torch

from hijiki_tpu_torch.ops import megakernel as mk
from hijiki_tpu_torch.ops import pallas_traverse as pt
from hijiki_tpu_torch.ops import sort as srt
from hijiki_tpu_torch.render import pallas_reconstruct as prc
from hijiki_tpu_torch.render.reconstruct import reconstruct_sweep
from hijiki_tpu_torch.render.renderer import RenderConfig, Renderer
from hijiki_tpu_torch.scene.compile import compile_scene
from hijiki_tpu_torch.scene.obj import load_obj_scene
from hijiki_tpu_torch.scene.presets import load_preset
from hijiki_tpu_torch.scene.compile import to_device
from torch_port_helpers import MESHBOX, MESHBOX_SMALL, cuda_device, frame_inputs, random_rays

pytestmark = pytest.mark.cuda


def _scene(path):
    if path.startswith("builtin:"):
        return compile_scene(load_preset(path[8:]))
    s = load_obj_scene(path)
    s.put_cbox_spheres()
    return compile_scene(s)


def _frame(S, dev):
    px, py, seeds = frame_inputs(S, S, 0.37, 0.61, 2654435761)
    return (torch.from_numpy(px).to(dev), torch.from_numpy(py).to(dev),
            torch.from_numpy(seeds.view(np.int32)).to(dev))


def _agree(k, p):
    same = (k[1] == p[1]).cpu().numpy()
    close = np.isclose(k[0][15:18].T.cpu().numpy(), p[0][15:18].T.cpu().numpy(),
                       rtol=2e-3, atol=2e-3).all(-1)
    assert same.mean() >= 0.995 and (same & close).mean() >= 0.995


@pytest.mark.parametrize("H,W", [(1024, 1024), (256, 1000)])
def test_reconstruct_kernel_matches_twin(H, W):
    dev = cuda_device()
    rng = np.random.default_rng(H + W)
    color = (rng.random((H, W, 3)) * 2).astype(np.float32)
    color[rng.random((H, W)) < 1e-3] = np.nan
    normal = rng.standard_normal((H, W, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    so = rng.random(2).astype(np.float32)
    c, n = torch.from_numpy(color).to(dev), torch.from_numpy(normal).to(dev)
    before = prc.LAUNCHES["reconstruct"]
    got = prc.reconstruct(c, n, so, block_size=128)
    assert prc.LAUNCHES["reconstruct"] == before + 1
    want = reconstruct_sweep(c, n, torch.zeros_like(c), so, block_size=128)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("path", [MESHBOX, MESHBOX_SMALL, "builtin:cornell-glass"])
def test_megakernel_matches_twin(path):
    dev = cuda_device()
    S = 64
    ms = mk.mega_scene(_scene(path), S, S, dev)
    px, py, seeds = _frame(S, dev)
    before = dict(mk.LAUNCHES)
    k1 = mk.megakernel_start(ms, px, py, seeds, 5)
    k2 = mk.megakernel_resume(ms, k1[0], k1[1], 24)
    assert mk.LAUNCHES["mk_start"] == before["mk_start"] + 1
    assert mk.LAUNCHES["mk_resume"] == before["mk_resume"] + 1
    _agree(k1, mk.megakernel_start_plain(ms, px, py, seeds, 5))
    _agree(k2, mk.megakernel_resume_plain(ms, k1[0], k1[1], 24))


def test_phased_kernels_equal_single_launch():
    dev = cuda_device()
    S = 128
    ms = mk.mega_scene(_scene(MESHBOX), S, S, dev)
    px, py, seeds = _frame(S, dev)
    one = mk.render_tiles(ms, px, py, seeds, max_bounces=64)
    waves = mk.render_waves(ms, px, py, seeds, max_bounces=64, phase_bounces=(5, 12))
    assert int(waves[4]) == 0
    assert torch.equal(one[3], waves[3])
    assert torch.equal(one[0], waves[0])


def test_chained_and_tiles_kernels_match_twins():
    dev = cuda_device()
    S = 64
    ms = mk.mega_scene(_scene(MESHBOX), S, S, dev)
    px, py, seeds = _frame(S, dev)
    pxs = torch.stack([px, px + 0.25, px - 0.25])
    pys = torch.stack([py, py - 0.125, py + 0.125])
    sds = torch.stack([seeds, seeds + 1, seeds + 977])
    before = dict(mk.LAUNCHES)
    pool, prng, co = mk.megakernel_start_chained(ms, pxs, pys, sds, 8)
    out, rng = mk.megakernel_tiles(ms, px, py, seeds, 24)
    assert mk.LAUNCHES["mk_start_chained"] == before["mk_start_chained"] + 1
    assert mk.LAUNCHES["mk_tiles"] == before["mk_tiles"] + 1
    wpool, wprng, wco = mk.megakernel_start_chained_plain(ms, pxs, pys, sds, 8)
    same = (prng == wprng).cpu().numpy()
    close = np.isclose((co[0:3] + pool[15:18]).T.cpu().numpy(),
                       (wco[0:3] + wpool[15:18]).T.cpu().numpy(), rtol=2e-3, atol=2e-3).all(-1)
    assert same.mean() >= 0.995 and (same & close).mean() >= 0.995
    wout, wrng = mk.megakernel_tiles_plain(ms, px, py, seeds, 24)
    same = (rng == wrng).cpu().numpy()
    close = np.isclose(out[0:3].T.cpu().numpy(), wout[0:3].T.cpu().numpy(),
                       rtol=2e-3, atol=2e-3).all(-1)
    assert same.mean() >= 0.995 and (same & close).mean() >= 0.995
    k1 = mk.megakernel_start(ms, px, py, seeds, 24)
    assert torch.equal(out, k1[0][list(mk._TILE_CH)]) and torch.equal(rng, k1[1])


def test_chained_equals_separate_sweeps_on_card():
    dev = cuda_device()
    S = 128
    ms = mk.mega_scene(_scene(MESHBOX), S, S, dev)
    px, py, seeds = _frame(S, dev)
    pxs = torch.stack([px, px + 0.25, px - 0.25])
    pys = torch.stack([py, py - 0.125, py + 0.125])
    sds = torch.stack([seeds, seeds + 1, seeds + 977])
    ch = mk.render_waves_chained(ms, pxs, pys, sds, max_bounces=64, chain_cap=8)
    assert int(ch[4]) == 0
    for s in range(3):
        ref = mk.render_waves(ms, pxs[s].contiguous(), pys[s].contiguous(), sds[s].contiguous(),
                              max_bounces=64)
        for i in (0, 1, 2, 3, 5, 7):
            assert torch.equal(ch[i][s], ref[i]), (i, s)


def test_wrapper_rejects_bad_inputs():
    dev = cuda_device()
    ms = mk.mega_scene(_scene(MESHBOX_SMALL), 8, 8, dev)
    px, py, seeds = _frame(8, dev)
    with pytest.raises(ValueError):
        mk.megakernel_start(ms, px.double(), py, seeds, 5)
    with pytest.raises(ValueError):
        mk.megakernel_start(ms, px, py, seeds.to(torch.int64), 5)


def test_renderer_on_card_matches_twin_renderer():
    dev = cuda_device()
    cs = _scene(MESHBOX_SMALL)
    cfg = RenderConfig(width=64, height=64, spp=2, seed=5)
    a = Renderer(cs, cfg, device=dev)
    a.render()
    b = Renderer(cs, cfg, device="cpu")
    b.render()
    close = np.isclose(a.film.cpu().numpy(), b.film.numpy(), rtol=2e-3, atol=2e-3).all(-1)
    assert close.mean() >= 0.90


def test_chained_renderer_on_card_matches_twin_renderer():
    """The default on the card chains (auto: 8, here a divisor of spp=6);
    the twin Renderer with the same chunking computes the same samples."""
    dev = cuda_device()
    cs = _scene(MESHBOX_SMALL)
    cfg = RenderConfig(width=64, height=64, spp=6, seed=5)
    a = Renderer(cs, cfg, device=dev)
    m = a.render()
    assert m["chain_chunk_sweeps"] == 6
    b = Renderer(cs, RenderConfig(width=64, height=64, spp=6, seed=5, chain_sweeps=6), device="cpu")
    b.render()
    close = np.isclose(a.film.cpu().numpy(), b.film.numpy(), rtol=2e-3, atol=2e-3).all(-1)
    assert close.mean() >= 0.90


@pytest.mark.parametrize("path", [MESHBOX, "builtin:cornell-glass"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_traverse_kernel_matches_twin(path, any_hit):
    """K6 against traverse_plain on random rays (inactive lanes, finite and
    infinite tmax, N no multiple of the block): every output channel."""
    dev = cuda_device()
    cs = to_device(_scene(path), dev)
    rays = [torch.from_numpy(x).to(dev) for x in random_rays(cs, 5000, seed=3)]
    before = pt.LAUNCHES["traverse"]
    got = pt.traverse(cs.trace_rows, *rays, any_hit=any_hit)
    assert pt.LAUNCHES["traverse"] == before + 1
    want = pt.traverse_plain(cs.trace_rows, *rays, any_hit=any_hit)
    assert torch.equal(got, want)
    assert (got[1] > 0).float().mean() > 0.3


def test_traverse_wrapper_rejects_bad_inputs():
    dev = cuda_device()
    cs = to_device(_scene(MESHBOX_SMALL), dev)
    o, d, tmin, tmax = (torch.from_numpy(x).to(dev) for x in random_rays(cs, 64, seed=1))
    with pytest.raises(ValueError):
        pt.traverse(cs.trace_rows, o.double(), d, tmin, tmax)
    with pytest.raises(ValueError):
        pt.traverse(cs.trace_rows, o, d[:, :2].contiguous(), tmin, tmax)


def test_sync_film_same_with_kernel_or_twin_walk(monkeypatch):
    """The sync driver on the card with K6, then with every K6 call replaced
    by its twin: the films are equal bit for bit; the K6 render launched K6
    and K3 and no megakernel."""
    dev = cuda_device()
    cs = _scene(MESHBOX)
    cfg = RenderConfig(width=128, height=128, spp=2, seed=7, driver="sync")
    for d in (mk.LAUNCHES, pt.LAUNCHES, prc.LAUNCHES):
        for k in d:
            d[k] = 0
    a = Renderer(cs, cfg, device=dev)
    a.render()
    assert pt.LAUNCHES["traverse"] > 0 and prc.LAUNCHES["reconstruct"] == 2
    assert not any(mk.LAUNCHES.values())
    monkeypatch.setattr(pt, "traverse", pt.traverse_plain)
    b = Renderer(cs, cfg, device=dev)
    b.render()
    assert torch.equal(a.film, b.film)


def test_wavefront_on_card_equals_sync_on_card():
    dev = cuda_device()
    cs = _scene(MESHBOX)
    cfg = dict(width=128, height=128, spp=1, seed=9)
    a = Renderer(cs, RenderConfig(driver="sync", **cfg), device=dev)
    a.render()
    b = Renderer(cs, RenderConfig(driver="wavefront", wavefront_lanes=4096, sort_lanes=True, **cfg),
                 device=dev)
    b.render()
    assert torch.equal(a.film, b.film)


def test_sync_renderer_on_card_matches_cpu_renderer():
    dev = cuda_device()
    cs = _scene(MESHBOX_SMALL)
    cfg = RenderConfig(width=64, height=64, spp=2, seed=5, driver="sync", max_bounces=24)
    a = Renderer(cs, cfg, device=dev)
    a.render()
    b = Renderer(cs, cfg, device="cpu")
    b.render()
    close = np.isclose(a.film.cpu().numpy(), b.film.numpy(), rtol=2e-3, atol=2e-3).all(-1)
    assert close.mean() >= 0.90


@pytest.mark.parametrize("traversal", ["rows", "packet"])
def test_bounce_step_reads_nothing_back(traversal):
    """Three bounces of the sync integrator on the card under
    torch.cuda.set_sync_debug_mode("error"): no op of bounce_step (the K6
    walks, NEE with the meshbox's triangle emitters, BSDF sampling) waits
    for the device, so the loop's any(alive) read is its only sync."""
    from hijiki_tpu_torch.ops.camera import camera_rays
    from hijiki_tpu_torch.ops.integrate import bounce_step, make_intersectors, start_lanes
    from hijiki_tpu_torch.ops.rng import from_bits, seed_rng

    dev = cuda_device()
    cs = to_device(_scene(MESHBOX), dev)
    px, py, seeds = _frame(64, dev)
    rays = camera_rays(cs.cam_position, cs.cam_rotation, cs.cam_fov, torch.stack([px, py], -1),
                       (64, 64))
    lanes = start_lanes(*rays, seed_rng(from_bits(seeds)))
    intersect, occluded = make_intersectors(cs, traversal)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            lanes = bounce_step(cs, lanes, intersect, occluded)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(lanes["bounce"].max()) == 3


def _bits(ts):
    return [t.view(torch.int32) if t.is_floating_point() else t for t in ts]


def test_sort_tiles_kernel_matches_plain():
    """K8 on 300 tiles (random keys, ties with dead keys, all equal) and 5
    channels: keys and payloads bit-equal to sort_tiles_plain."""
    dev = cuda_device()
    rng = np.random.default_rng(21)
    key = rng.integers(0, 5000, (300, srt.TILE))
    key[100:200] = rng.integers(0, 8, (100, srt.TILE))
    key[100:200][rng.random((100, srt.TILE)) < 0.3] = 1 << 20
    key[200:] = 7
    key = torch.from_numpy(key.astype(np.int32)).to(dev)
    ch = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (5, 300, srt.TILE)).astype(np.int32)).to(dev)
    before = srt.LAUNCHES["sort_tiles"]
    got = srt.sort_tiles(key, ch)
    assert srt.LAUNCHES["sort_tiles"] == before + 1
    want = srt.sort_tiles_plain(key, ch)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        srt.sort_tiles(key[:, :512].contiguous(), ch[:, :, :512].contiguous())


def _special_state(st, stuck, cap, lo, hi, seed):
    """A K2 input whose ``stuck`` lanes are alive at ``cap`` bounces (so no
    bounce moves them and the sort keys them as they are) with origins
    that test the key: NaN, +-inf, +-1e30, the scene box's bounds and
    points outside it; directions with 0 and -0.0 components."""
    st = st.clone()
    g = np.random.default_rng(seed)
    m = int(stuck.sum())
    o = lo - 0.5 * (hi - lo) + 2.0 * (hi - lo) * g.random((m, 3))
    special = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30], np.float32)
    for a in range(3):
        o[a::5, a] = special[g.integers(0, len(special), len(o[a::5]))]
        o[1 + a::7, a] = lo[a]
        o[2 + a::9, a] = hi[a]
    d = g.standard_normal((m, 3))
    d[::4, 0] = 0.0
    d[1::6, 1] = -0.0
    st[0, stuck] = 1.0
    st[1, stuck] = float(cap)
    st[2:5, stuck] = torch.from_numpy(o.T.astype(np.float32)).to(st.device)
    st[5:8, stuck] = torch.from_numpy(d.T.astype(np.float32)).to(st.device)
    return st


def _assert_same_sort(got, want):
    """outputs (every channel, int32 views) and the order record bit-equal"""
    assert all(torch.equal(g, w) for g, w in zip(_bits(got), _bits(want)))


@pytest.mark.parametrize("path", [MESHBOX, "builtin:cornell-glass"])
def test_sorted_kernels_equal_unsorted(path):
    """The lane-sorted K1 (cap 5), K2 (resume to 64) and K5 (to 64, on a
    lane count that is no multiple of the tile) against the unsorted
    kernels, bit for bit on every output; and their order record (the path
    id at each lane after the last sort, and its key) bit-equal to the
    sorted plain version's, which shows the sort itself."""
    dev = cuda_device()
    S = 64
    ms = mk.mega_scene(_scene(path), S, S, dev)
    px, py, seeds = _frame(S, dev)
    before = dict(mk.LAUNCHES)
    k1s = mk.megakernel_start(ms, px, py, seeds, 5, lane_sort=True, lane_order=True)
    k1 = mk.megakernel_start(ms, px, py, seeds, 5)
    k2s = mk.megakernel_resume(ms, *k1, 64, lane_sort=True, lane_order=True)
    part = [a[:4000].contiguous() for a in (px, py, seeds)]
    k5s = mk.megakernel_tiles(ms, *part, 64, lane_sort=True, lane_order=True)
    for name in ("mk_start_sorted", "mk_resume_sorted", "mk_tiles_sorted"):
        assert mk.LAUNCHES[name] == before[name] + 1
    for got, want in ((k1s, k1), (k2s, mk.megakernel_resume(ms, *k1, 64)),
                      (k5s, mk.megakernel_tiles(ms, *part, 64))):
        _assert_same_sort(got[:2], want)
    _assert_same_sort(k1s, mk.megakernel_start_plain(ms, px, py, seeds, 5, lane_sort=True,
                                                     lane_order=True))
    _assert_same_sort(k2s, mk.megakernel_resume_plain(ms, *k1, 64, lane_sort=True,
                                                      lane_order=True))
    _assert_same_sort(k5s, mk.megakernel_tiles_plain(ms, *part, 64, lane_sort=True,
                                                     lane_order=True))
    assert not torch.equal(k1s[2][0], torch.arange(S * S, dtype=torch.int32, device=dev))


def test_sorted_kernel_key_matches_plain():
    """The kernel's lane key on origins at NaN, +-inf, +-1e30, the box's
    bounds and outside it, and on 0 / -0.0 directions: one sorted resume
    pass in which a third of the lanes are alive at the cap, against the
    plain version (outputs and order record bit-equal), and the recorded
    keys equal to lane_sort_key of the states they came from."""
    dev = cuda_device()
    S = 64
    cs = _scene(MESHBOX)
    ms = mk.mega_scene(cs, S, S, dev)
    st, rng = mk.megakernel_start(ms, *_frame(S, dev), 2)
    stuck = torch.arange(S * S, device=dev) % 3 == 0
    bb = np.asarray(cs.bbox_static, np.float64)
    st = _special_state(st, stuck, 4, bb[:3], bb[3:], 17)
    got = mk.megakernel_resume(ms, st, rng, 4, lane_sort=True, lane_order=True)
    _assert_same_sort(got, mk.megakernel_resume_plain(ms, st, rng, 4, lane_sort=True,
                                                      lane_order=True))
    pid, key = got[2][0].long(), got[2][1]
    assert torch.equal(key, mk.lane_sort_key(ms, mk._unpack(*got[:2]))[pid])
    assert torch.isnan(got[0][2:5, stuck]).any() and len(torch.unique(key)) > 50


def test_sorted_renderer_on_card_equals_unsorted():
    dev = cuda_device()
    cs = _scene(MESHBOX)
    cfg = dict(width=128, height=128, spp=2, seed=5, chain_sweeps=1)
    a = Renderer(cs, RenderConfig(**cfg), device=dev)
    a.render()
    before = mk.LAUNCHES["mk_start_sorted"]
    b = Renderer(cs, RenderConfig(**cfg, sort_lanes=True), device=dev)
    b.render()
    assert mk.LAUNCHES["mk_start_sorted"] == before + 2
    assert torch.equal(a.film, b.film)
