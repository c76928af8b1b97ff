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
permutation of whole paths), also on 397 tiles and on heavy dead-key ties; K6's strict and inclusive any-hit bit-equal
to the plain walk at tmax = the closest hit's t; K9 (reconstruct_old) to
K3's bound; the K11b bodies (alu_issue, dtype_elementwise in f32, bf16 and
bf16x2, dtype_slab in f32 and bf16) bit-equal to their plain versions; the
persistent K4 (into NaN-filled outputs: it writes every slot it owns),
K1 (n = 1, 127, 129, 4097 at caps 1, 5, 1000) and K5 (n = 1, 31, 129,
4097 at caps 5 and 1000, likewise into NaN-filled outputs, and a 256x256
frame to 1000), K2 at caps
12, 48 and 1000, and K2 and K10b on axis-aligned rays (the slab test's NaN
path) bit-equal to their twins on every output; K3 on an 8-sweep chunk
bit-equal to its one-sweep launches summed in sweep order (B = 1, 2, 3, 4,
128); K6 bit-equal to its twin on dead, sparse, NaN-bound and
zero-direction rays in all three modes; K8 bit-equal to its plain version
for T = 1, 3, 300 tiles and C = 0, 1, 8, 31, 33 channels (none a whole
number of its batches but 8) on random keys, all-equal keys, ties with
dead keys and INT_MIN/INT_MAX."""

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


# ---- the walker-cost probes (K10a, K10b, K11a): each kernel bit-equal to
# its plain version at 64x64-sized inputs (4096 threads) ----

def _probe_scene(dev):
    from hijiki_tpu_torch.probes.walk_probe import load_scene

    return load_scene(MESHBOX, dev, 64, 64)


@pytest.mark.parametrize("group", [1, 32])
@pytest.mark.parametrize("variant", ["full", "nocount", "noreduce", "noprim", "noslab",
                                     "noprefetch", "nofetch", "onlyfetch", "onlyloop",
                                     "nofetch_noreduce", "noprim_noreduce"])
def test_walk_ablate_kernel_matches_plain(variant, group):
    from hijiki_tpu_torch.probes import ablate_walker as A
    from hijiki_tpu_torch.probes.walk_probe import ray_set

    dev = cuda_device()
    ms, cs = _probe_scene(dev)
    o, d = ray_set("random", cs, 64 * 64, dev)
    before = A.LAUNCHES["walk_ablate"]
    got = A.walk_ablate(ms.rows, o, d, 40, A.VARIANTS[variant], group)
    assert A.LAUNCHES["walk_ablate"] == before + 1
    want = A.walk_ablate_plain(ms.rows, o, d, 40, A.VARIANTS[variant], group)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_walk_ablate_loads_rows_128_bits_wide():
    """Every K10a instantiation's SASS (cuobjdump of the built library)
    loads the table's rows as the render walk does, 128 bits a load, with
    no fewer LDG.E.128 than its source's float4 loads and no narrower LDG
    in a loop, whatever columns the variant reads."""
    from hijiki_tpu_torch.probes import ablate_walker as A

    cuda_device()
    assert len(A.check_row_loads()) == len(A.VARIANTS) * 2


def test_packed_walks_keep_local_memory_out_of_walk_loops():
    """Every packed walk of K10b (test and notest, G 1 and 32), K1 and K4
    (each packed format, the occlusion cache off and on, and the dedicated
    shadow table) has its walk loops in its SASS and no LDL/STL in them
    (walk_probe.check_packed_loads)."""
    from hijiki_tpu_torch.probes import walk_probe as W

    cuda_device()
    assert len(W.check_packed_loads()) == sum(len(t) for t in W.PACKED_KERNELS.values())


@pytest.mark.parametrize("group", [1, 32])
@pytest.mark.parametrize("variant", ["w32", "w32-notest", "w16", "w16-notest", "slim",
                                     "slim-notest", "pack3", "pack3-notest", "pack4",
                                     "pack4-notest", "pack12", "pack12-notest"])
@pytest.mark.parametrize("rays", ["camera", "random"])
def test_walk_isolate_kernel_matches_plain(rays, variant, group):
    """K10b on the classic rows, their 16-column copy and each packed
    table (walk_isolate_packed_kernel), with and without the prim test, a
    thread or a warp a cursor: t and rows visited bit-equal to the plain
    version."""
    from hijiki_tpu_torch.probes import walk_probe as W

    dev = cuda_device()
    table, test = W.VARIANTS[variant]
    ms, cs = W.load_scene(MESHBOX, dev, 64, 64, W.TABLES[table])
    o, d = W.ray_set(rays, cs, 64 * 64, dev, frame=64)
    rows = W.w16_rows(ms.rows).contiguous() if table == "w16" else ms.rows
    got = W.walk_isolate(ms, rows, o, d, test=test, group=group, iters=3)
    want = W.walk_isolate_plain(ms, rows, o, d, test=test, group=group)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("case", ["alu8", "alu16", "alu32", "vote1", "vote32", "fetch_indep1",
                                  "fetch_indep2", "fetch_chase1", "chain1", "chain32",
                                  "gather_const", "gather1", "gatherK"])
def test_latency_chain_kernel_matches_plain(case):
    import numpy as np

    from hijiki_tpu_torch.probes import chain_latency_probe as C
    from hijiki_tpu_torch.probes import gather_probe as G

    dev = cuda_device()
    n, it = 64 * 64, 50
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if case.startswith("alu"):
        x = T(C.x_of(n))
        got, want = C.alu(x, it, int(case[3:])), C.alu_plain(x, it, int(case[3:]))
    elif case.startswith("vote"):
        x = T(C.x_of(n, scale=0.4))
        g = int(case[4:])
        got, want = C.vote(x, it, g), C.vote_plain(x, it, g)
    elif case.startswith("fetch"):
        tbl = T(C.fetch_table())
        mode, h = case[6:-1], int(case[-1])
        got, want = C.fetch(tbl, n, it, mode, h), C.fetch_plain(tbl, n, it, mode, h)
    elif case.startswith("chain"):
        tbl, x = C.chain_table()
        tbl, x = T(tbl), T(C.x_of(n) + np.float32(0.5))
        g = int(case[5:])
        got, want = C.chain(tbl, x, it, g), C.chain_plain(tbl, x, it, g)
    else:
        tbl, idx = (T(a) for a in G.gather_inputs(n, 4))
        mode = case[7:] if case == "gather_const" else case
        got, want = G.gather(tbl, idx, it, mode), G.gather_plain(tbl, idx, it, mode)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("case", ["indep1", "indep2", "indep4", "chase1", "chase2", "chase4",
                                  "sharedsem1", "sharedsem2", "sharedsem4", "sharedsem+noclamp1",
                                  "dedup1", "multi1", "multi2", "multi4", "multi1spec",
                                  "multi2spec", "multi4spec"])
def test_staged_chase_kernel_matches_plain(case, nblk=128, block=None):
    """K11a staged_chase (cp.async copies, float4 stores) bit-equal to its plain
    version in every mode at every height it takes (the unclamped modes
    at height 1) and every multi case."""
    from hijiki_tpu_torch.probes import chain_latency_probe as C

    dev = cuda_device()
    it = 50
    spec = case.endswith("spec")
    case = case[:-4] if spec else case
    mode, k = case[:-1], int(case[-1])
    tbl = torch.from_numpy(C.dma_table(65536, height=2 if mode == "multi" else k)).to(dev)
    kw = {} if block is None else dict(block=block)
    before = C.LAUNCHES["staged_chase"]
    if mode == "multi":
        got = C.staged_chase(tbl, nblk, it, "multi", nchains=k, spec=spec, **kw)
        want = C.staged_multi_plain(tbl, nblk, it, k, spec)
    else:
        got = C.staged_chase(tbl, nblk, it, mode, k, **kw)
        want = C.staged_plain(tbl, nblk, it, mode, k)
    assert C.LAUNCHES["staged_chase"] == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("block", [32, 64, 256])
@pytest.mark.parametrize("case", ["chase1", "indep4", "dedup1", "multi2spec"])
def test_staged_chase_blocks_of_any_warps(case, block):
    """The same at 32, 64 and 256 threads a block (each warp its own
    rows) and 127 warps, so the last block holds warps past
    nblk that return at once."""
    test_staged_chase_kernel_matches_plain(case, nblk=127, block=block)


def test_probe_wrappers_refuse_unaligned_tables():
    """K10a reads a row's columns 16 bytes at a time and staged_chase copies
    rows 16 bytes a lane: a table one float into its storage (not
    on a 16-byte boundary) is refused, not read misaligned."""
    from hijiki_tpu_torch.probes import ablate_walker as A
    from hijiki_tpu_torch.probes import chain_latency_probe as C
    from hijiki_tpu_torch.probes.walk_probe import ray_set

    dev = cuda_device()

    def shifted(t):
        flat = torch.empty(t.numel() + 1, device=dev)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 16
        return out

    ms, cs = _probe_scene(dev)
    o, d = ray_set("random", cs, 256, dev)
    with pytest.raises(ValueError, match="16-byte"):
        A.walk_ablate(shifted(ms.rows), o, d, 4, {}, 1)
    tbl = torch.from_numpy(C.dma_table(4096)).to(dev)
    for mode in ("chase", "multi"):
        with pytest.raises(ValueError, match="16-byte"):
            C.staged_chase(shifted(tbl), 4, 2, mode)


@pytest.mark.parametrize("path", [MESHBOX, "builtin:cornell-glass"])
def test_traverse_any_hit_modes_at_tmax(path):
    """tmax = the closest hit's t: K6's strict and inclusive any-hit each
    bit-equal to the plain walk, and the two modes tell some ray apart."""
    dev = cuda_device()
    cs = to_device(_scene(path), dev)
    o, d, tmin, tmax = (torch.from_numpy(x).to(dev) for x in random_rays(cs, 5000, seed=3))
    closest = pt.traverse(cs.trace_rows, o, d, tmin, tmax)
    at = torch.where(closest[1] > 0, closest[0], tmax)
    answers = []
    for inclusive in (False, True):
        before = pt.LAUNCHES["traverse"]
        got = pt.traverse(cs.trace_rows, o, d, tmin, at, any_hit=True, inclusive=inclusive)
        assert pt.LAUNCHES["traverse"] == before + 1
        want = pt.traverse_plain(cs.trace_rows, o, d, tmin, at, any_hit=True, inclusive=inclusive)
        assert torch.equal(got, want)
        answers.append(got[1] > 0)
    assert (answers[1] & ~answers[0]).any() and not (answers[0] & ~answers[1]).any()


@pytest.mark.parametrize("H,W", [(1024, 1024), (1000, 1024)])
def test_reconstruct_old_kernel_matches_plain(H, W):
    """K9 against its plain version (K3's bound: expf ULPs), with NaN
    pixels and rows no multiple of 8; K9 against K3 to the same bound."""
    from hijiki_tpu_torch.probes import ab_reconstruct as K9

    dev = cuda_device()
    color, normal, so = K9.inputs(W, H, dev)
    color[3, 5, 1] = float("nan")
    normal[H // 2, 10, 2] = float("nan")
    before = K9.LAUNCHES["reconstruct_old"]
    got = K9.reconstruct_old(color, normal, so, block_size=128)
    assert K9.LAUNCHES["reconstruct_old"] == before + 1
    planes = K9.planes_of(color, normal)
    want = K9.reconstruct_old_plain(planes, H, so, block_size=128)
    assert got.shape == (H, W, 4) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-6)
    k3 = prc.reconstruct(color, normal, so, block_size=128)
    np.testing.assert_allclose(got.cpu().numpy(), k3.cpu().numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("n", [4096, 1 << 20])
def test_alu_issue_kernel_matches_plain(k, n):
    from hijiki_tpu_torch.probes import vpu_issue_probe as I

    dev = cuda_device()
    x = torch.from_numpy(I.x_of(n)).to(dev)
    before = I.LAUNCHES["alu_issue"]
    got = I.alu_issue(x, 6, k)
    assert I.LAUNCHES["alu_issue"] == before + 1
    assert torch.equal(got, I.alu_issue_plain(x, 6, k))
    assert I.alu_issue(x, 6, k, occupancy=True) > 0
    assert I.LAUNCHES["alu_issue"] == before + 1


@pytest.mark.parametrize("chains", [1, 8])
@pytest.mark.parametrize("variant", ["f32", "bf16", "bf16x2"])
@pytest.mark.parametrize("n", [4096, 1 << 20])
def test_dtype_elementwise_kernel_matches_plain(variant, chains, n):
    from hijiki_tpu_torch.probes import vpu_dtype_probe as D

    dev = cuda_device()
    x = D.ew_input(chains, n, "f32" if variant == "f32" else "bf16").to(dev)
    before = D.LAUNCHES["dtype_elementwise"]
    got = D.dtype_elementwise(x, 7, variant)
    assert D.LAUNCHES["dtype_elementwise"] == before + 1
    assert torch.equal(got, D.ew_plain(x, 7))
    if variant == "bf16x2":
        assert torch.equal(got, D.dtype_elementwise(x, 7, "bf16"))
        # the packed lanes are element-wise: swapping the input pairs swaps the output pairs
        swapped = x.reshape(chains, -1, 2).flip(-1).reshape(chains, -1).contiguous()
        assert torch.equal(D.dtype_elementwise(swapped, 7, variant),
                           got.reshape(-1, 2).flip(-1).reshape(-1))
        assert not torch.equal(got.reshape(-1, 2)[:, 0], got.reshape(-1, 2)[:, 1])


@pytest.mark.parametrize("variant", ["f32", "bf16"])
@pytest.mark.parametrize("rows", [8, 1024])
def test_dtype_slab_kernel_matches_plain(variant, rows):
    from hijiki_tpu_torch.probes import vpu_dtype_probe as D

    dev = cuda_device()
    x, row = (t.to(dev) for t in D.slab_input(rows, 1024))
    before = D.LAUNCHES["dtype_slab"]
    got = D.dtype_slab(x, row, 9, variant)
    assert D.LAUNCHES["dtype_slab"] == before + 1
    assert torch.equal(got, D.slab_plain(x, row, 9, variant))


# ---- the persistent K4, K2 and the row step (min.NaN slab test, 128-bit
# row loads): bit-equal to the twins ----

# lanes of these tests: no multiple of a warp or a block
ODD_LANES = 64 * 64 - 37


def _samples(S, dev):
    """(S, ODD_LANES) jittered pixel coordinates and seeds, one set a sample."""
    px, py, seeds = _frame(64, dev)
    k = torch.arange(S, device=dev, dtype=torch.float32).view(-1, 1)
    return ((px[:ODD_LANES] + 0.17 * k).contiguous(), (py[:ODD_LANES] - 0.11 * k).contiguous(),
            (seeds[:ODD_LANES] + 977 * k.int()).contiguous())


@pytest.mark.parametrize("S", [1, 3, 8])
def test_persistent_chained_kernel_bit_equal_to_twin(S):
    """K4 on S samples of 4059 lanes, chain cap 8: the pool, the RNG pool
    and the flush buffer bit-equal to megakernel_start_chained_plain
    through the wrapper (zeroed outputs); and, into outputs filled with NaN
    first, every slot the kernel writes bit-equal to the twin's: the whole
    RNG pool, a parked slot's pool column, a flushed slot's flush column."""
    dev = cuda_device()
    ms = mk.mega_scene(_scene(MESHBOX), 64, 64, dev)
    pxs, pys, sds = _samples(S, dev)
    n = ODD_LANES
    nan = float("nan")
    outs = [torch.full((mk.N_STATE, S * n), nan, device=dev),
            torch.full((S * n,), nan, device=dev).view(torch.int32),
            torch.full((mk.CHAIN_OUT_CH, S * n), nan, device=dev)]
    before = mk.LAUNCHES["mk_start_chained"]
    got = mk._launch("mk_start_chained", ms, [pxs, pys, sds], [n, S, 8], outs, persistent=True)
    wrapped = mk.megakernel_start_chained(ms, pxs, pys, sds, 8)
    assert mk.LAUNCHES["mk_start_chained"] == before + 2
    want = mk.megakernel_start_chained_plain(ms, pxs, pys, sds, 8)
    assert all(torch.equal(g, w) for g, w in zip(_bits(wrapped), _bits(want)))
    parked = want[0][0] > 0
    assert parked.any() and (~parked).any()
    (pool, rng, flush), (wpool, wrng, wflush) = _bits(got), _bits(want)
    assert torch.equal(rng, wrng)
    assert torch.equal(pool[:, parked], wpool[:, parked])
    assert torch.equal(flush[:, ~parked], wflush[:, ~parked])


@pytest.mark.parametrize("cap", [12, 48, 1000])
def test_resume_kernel_bit_equal_to_twin(cap):
    """K2 (the new row step inside) resuming 4059 lanes of a K1 state at cap
    5 (dead and live lanes mixed) to ``cap``: state and RNG bit-equal to the
    twin."""
    dev = cuda_device()
    ms = mk.mega_scene(_scene(MESHBOX), 64, 64, dev)
    px, py, seeds = (a[:ODD_LANES].contiguous() for a in _frame(64, dev))
    st, rng = mk.megakernel_start(ms, px, py, seeds, 5)
    before = mk.LAUNCHES["mk_resume"]
    got = mk.megakernel_resume(ms, st, rng, cap)
    assert mk.LAUNCHES["mk_resume"] == before + 1
    want = mk.megakernel_resume_plain(ms, st, rng, cap)
    assert all(torch.equal(g, w) for g, w in zip(_bits(got), _bits(want)))
    assert (st[0] > 0).any() and (st[0] == 0).any()


def _axis_rays(ms, m, seed):
    """m rays with axis-aligned directions (one component +-1, the others 0
    or -0.0) whose origins lie, on a zero-direction axis, on a face of an
    interior row's box, so the slab test meets 0 * inf and inf - inf."""
    rows = ms.rows.cpu().numpy()
    g = np.random.default_rng(seed)
    boxes = rows[rows[:, 9] < 0]
    lo, hi = boxes[0, 0:3], boxes[0, 3:6]  # the root's box: the scene's
    o = lo + (hi - lo) * g.random((m, 3))
    d = np.zeros((m, 3))
    axis = g.integers(0, 3, m)
    d[np.arange(m), axis] = np.where(g.random(m) < 0.5, 1.0, -1.0)
    d[(np.arange(m) % 5 == 0)[:, None] & (d == 0)] = -0.0
    face = (axis + 1 + g.integers(0, 2, m)) % 3  # a zero-direction axis
    pick = boxes[g.integers(0, len(boxes), m)]
    o[np.arange(m), face] = pick[np.arange(m), face + 3 * g.integers(0, 2, m)]
    return o.astype(np.float32), d.astype(np.float32)


def test_axis_aligned_rays_bit_equal_to_twin():
    """Rays with direction components exactly 0 (and -0.0), origins on box
    faces: the slab test's NaN path, now min.NaN/max.NaN, decides as the
    twin's NaN-propagating min/max. K2 resuming such rays to cap 12, and
    K10b walking them, bit-equal to their plain versions."""
    from hijiki_tpu_torch.probes import walk_probe as W

    dev = cuda_device()
    ms = mk.mega_scene(_scene(MESHBOX), 64, 64, dev)
    px, py, seeds = _frame(64, dev)
    st, rng = mk.megakernel_start(ms, px, py, seeds, 0)  # fresh camera paths
    o, d = _axis_rays(ms, px.numel(), 5)
    st = st.clone()
    st[2:5] = torch.from_numpy(o.T.copy()).to(dev)
    st[5:8] = torch.from_numpy(d.T.copy()).to(dev)
    got = mk.megakernel_resume(ms, st, rng, 12)
    want = mk.megakernel_resume_plain(ms, st, rng, 12)
    assert all(torch.equal(g, w) for g, w in zip(_bits(got), _bits(want)))
    ot, dt = (torch.from_numpy(a.T.copy()).to(dev) for a in (o, d))
    got = W.walk_isolate(ms, ms.rows, ot, dt)
    want = W.walk_isolate_plain(ms, ms.rows, ot, dt)
    assert all(torch.equal(g, w) for g, w in zip(_bits(got), _bits(want)))
    # the NaN path ran: some ray's slab values at the root are NaN
    r = ms.rows[0]
    with np.errstate(all="ignore"):
        inv = 1.0 / d
        slab = np.concatenate([r[0:3].cpu().numpy() * inv - o * inv,
                               r[3:6].cpu().numpy() * inv - o * inv], 1)
    assert np.isnan(slab).any()


def test_wrapper_rejects_unaligned_rows():
    """The walk loads a row's columns 16 bytes at a time: a table that does
    not start on a 16-byte boundary is refused, not read misaligned."""
    import dataclasses

    dev = cuda_device()
    ms = mk.mega_scene(_scene(MESHBOX_SMALL), 8, 8, dev)
    flat = torch.empty(ms.rows.numel() + 1, device=dev)
    shifted = flat[1:].view(ms.rows.shape)
    shifted.copy_(ms.rows)
    bad = dataclasses.replace(ms, rows=shifted)
    with pytest.raises(ValueError):
        mk.megakernel_start(bad, *_frame(8, dev), 5)


def test_megakernels_occupancy():
    """mk_occupancy answers for all seven megakernels (K1, K2, K4, K5 and
    the sorted K1/K2/K5, these in blocks of SORT_TILE threads with their
    shared memory): registers, resident warps and the card's SMs. K4, K1
    and K5 (the stash, 6 blocks of 128) and the sorted kernels (the stash in the
    exchange buffer, 3 blocks of 256) hold 24 warps an SM, and ptxas
    spilled no bytes of them."""
    cuda_device()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in mk._OCCUPANCY_OF:
        occ = mk.occupancy(name)
        threads = mk.SORT_TILE if name.endswith("_sorted") else 128
        assert 0 < occ["registers"] <= 255 and occ["warps_per_sm"] >= 4
        assert occ["threads"] == threads and occ["sms"] == sms
        assert occ["warps_per_sm"] == occ["blocks_per_sm"] * threads // 32
    for name in ("mk_start", "mk_start_chained", "mk_tiles", "mk_start_sorted", "mk_resume_sorted",
                 "mk_tiles_sorted"):
        occ = mk.occupancy(name)
        assert occ["warps_per_sm"] == 24 and occ["spill_bytes"] == 0, (name, occ)


# ptxas' registers and spill-store bytes a thread, and the resident warps
# an SM, of each megakernel's instantiation for each trace-row format, as
# built for the NVIDIA H100 80GB HBM3 (chip_smoke.py phase 6 prints them):
# mk_start, mk_resume, mk_start_chained, mk_tiles and the sorted mk_start,
# mk_resume, mk_tiles (mk._OCCUPANCY_OF's order)
FORMAT_OCCUPANCY = {
    "classic": ((80, 0, 24), (96, 16, 20), (80, 0, 24), (80, 0, 24), (80, 0, 24), (80, 0, 24), (80, 0, 24)),
    "slim": ((80, 0, 24), (96, 8, 20), (80, 4, 24), (80, 0, 24), (80, 0, 24), (80, 0, 24), (80, 0, 24)),
    "packed3": ((80, 8, 24), (109, 0, 16), (80, 4, 24), (80, 0, 24), (80, 0, 24), (80, 0, 24), (80, 0, 24)),
    "packed4": ((80, 16, 24), (113, 0, 16), (80, 12, 24), (80, 0, 24), (80, 4, 24), (80, 4, 24), (80, 4, 24)),
    "packed12": ((80, 12, 24), (96, 4, 20), (80, 8, 24), (80, 8, 24), (80, 0, 24), (80, 0, 24), (80, 0, 24)),
    "shadow_tbl": ((80, 0, 24), (108, 0, 16), (80, 0, 24), (80, 0, 24), (80, 0, 24), (80, 0, 24), (80, 0, 24)),
    # the occlusion cache's instantiations (kCache)
    "classic_cache": ((80, 0, 24), (96, 40, 20), (80, 0, 24), (80, 0, 24), (80, 0, 24), (80, 0, 24), (80, 0, 24)),
    "slim_cache": ((80, 0, 24), (96, 40, 20), (80, 0, 24), (80, 0, 24), (80, 0, 24), (80, 0, 24), (80, 0, 24)),
    "packed3_cache": ((80, 0, 24), (108, 0, 16), (80, 0, 24), (80, 0, 24), (80, 0, 24), (80, 0, 24), (80, 0, 24)),
    "packed4_cache": ((80, 0, 24), (109, 0, 16), (80, 0, 24), (80, 0, 24), (80, 0, 24), (80, 0, 24), (80, 0, 24)),
    "packed12_cache": ((80, 0, 24), (117, 0, 16), (80, 0, 24), (80, 0, 24), (80, 0, 24), (80, 0, 24), (80, 0, 24)),
}


@pytest.mark.parametrize("fmt", list(mk.KERNEL_FORMATS))
def test_format_kernels_occupancy(fmt):
    """Each of the seven megakernels' instantiation for ``fmt`` uses no
    more registers and spills no more bytes than FORMAT_OCCUPANCY records,
    and holds as many resident warps an SM, or more."""
    cuda_device()
    for name, (regs, spill, warps) in zip(mk._OCCUPANCY_OF, FORMAT_OCCUPANCY[fmt], strict=True):
        occ = mk.occupancy(name, fmt=fmt)
        assert occ["registers"] <= regs and occ["spill_bytes"] <= spill, (name, fmt, occ)
        assert occ["warps_per_sm"] >= warps, (name, fmt, occ)


@pytest.mark.parametrize("cap", [1, 5, 1000])
@pytest.mark.parametrize("n", [1, 127, 129, 4097])
def test_persistent_start_kernel_bit_equal_to_twin(n, cap):
    """K1, persistent (threads take paths from a work counter, a bounce at
    a time), on n paths (fewer than a warp, than a block, more than a
    block, a tail past 32 blocks) to ``cap``: into outputs filled with NaN
    first (it writes every path's column) and through the wrapper, state
    and RNG bit-equal to megakernel_start_plain."""
    dev = cuda_device()
    ms = mk.mega_scene(_scene(MESHBOX), 65, 65, dev)
    px, py, seeds = (a[:n].contiguous() for a in _frame(65, dev))
    nan = float("nan")
    outs = [torch.full((mk.N_STATE, n), nan, device=dev),
            torch.full((n,), nan, device=dev).view(torch.int32)]
    before = mk.LAUNCHES["mk_start"]
    got = mk._launch("mk_start", ms, [px, py, seeds], [n, cap], outs, persistent=True)
    wrapped = mk.megakernel_start(ms, px, py, seeds, cap)
    assert mk.LAUNCHES["mk_start"] == before + 2
    want = mk.megakernel_start_plain(ms, px, py, seeds, cap)
    assert all(torch.equal(g, w) for g, w in zip(_bits(got), _bits(want)))
    assert all(torch.equal(g, w) for g, w in zip(_bits(wrapped), _bits(want)))


@pytest.mark.parametrize("cap", [5, 1000])
@pytest.mark.parametrize("n", [1, 31, 129, 4097])
def test_persistent_tiles_kernel_bit_equal_to_twin(n, cap):
    """K5, persistent as K1 is, on n paths (fewer than a warp, less than a
    warp short of one, more than a block, a tail past 32 blocks) to
    ``cap``: into outputs filled with NaN first (every path's column is
    written) and through the wrapper, result and RNG bit-equal to
    megakernel_tiles_plain."""
    dev = cuda_device()
    ms = mk.mega_scene(_scene(MESHBOX), 65, 65, dev)
    px, py, seeds = (a[:n].contiguous() for a in _frame(65, dev))
    nan = float("nan")
    outs = [torch.full((len(mk._TILE_CH), n), nan, device=dev),
            torch.full((n,), nan, device=dev).view(torch.int32)]
    before = mk.LAUNCHES["mk_tiles"]
    got = mk._launch("mk_tiles", ms, [px, py, seeds], [n, cap], outs, persistent=True)
    wrapped = mk.megakernel_tiles(ms, px, py, seeds, cap)
    assert mk.LAUNCHES["mk_tiles"] == before + 2
    want = mk.megakernel_tiles_plain(ms, px, py, seeds, cap)
    assert all(torch.equal(g, w) for g, w in zip(_bits(got), _bits(want)))
    assert all(torch.equal(g, w) for g, w in zip(_bits(wrapped), _bits(want)))


def test_persistent_tiles_kernel_bit_equal_on_a_frame():
    """K5 on a 256x256 frame of the meshbox with the cbox spheres to 1000
    bounces: result and RNG bit-equal to the plain version, and equal to
    K1's state at that cap on the same channels."""
    dev = cuda_device()
    ms = mk.mega_scene(_scene(MESHBOX), 256, 256, dev)
    px, py, seeds = _frame(256, dev)
    got = mk.megakernel_tiles(ms, px, py, seeds, 1000)
    want = mk.megakernel_tiles_plain(ms, px, py, seeds, 1000)
    assert all(torch.equal(g, w) for g, w in zip(_bits(got), _bits(want)))
    st, rng = mk.megakernel_start(ms, px, py, seeds, 1000)
    assert torch.equal(got[0].view(torch.int32), st[list(mk._TILE_CH)].view(torch.int32))
    assert torch.equal(got[1], rng)


def _sort_keys(kind, T, rng):
    """(T, TILE) int32 keys of one kind: random over the whole int32 range,
    all equal, few values tied with many dead keys (1 << 20), or only
    INT_MIN and INT_MAX with a few values between."""
    shape = (T, srt.TILE)
    if kind == "random":
        return rng.integers(-2**31, 2**31, shape)
    if kind == "equal":
        return np.full(shape, 7)
    if kind == "dead_ties":
        key = rng.integers(0, 8, shape)
        key[rng.random(shape) < 0.4] = 1 << 20
        return key
    key = np.where(rng.random(shape) < 0.5, -2**31, 2**31 - 1)
    key[rng.random(shape) < 0.05] = 0
    return key


@pytest.mark.parametrize("kind", ["random", "equal", "dead_ties", "extremes"])
@pytest.mark.parametrize("C", [0, 1, 8, 31, 33])
@pytest.mark.parametrize("T", [1, 3, 300])
def test_sort_tiles_kernel_bit_equal_to_plain(T, C, kind):
    """K8 on T tiles and C channels (C = 0: the keys alone; 1, 31, 33: a
    last batch of channels that is not full) with keys of ``kind``: keys
    and channels bit-equal to sort_tiles_plain."""
    dev = cuda_device()
    rng = np.random.default_rng(1000 * T + 10 * C + len(kind))
    key = torch.from_numpy(_sort_keys(kind, T, rng).astype(np.int32)).to(dev)
    ch = torch.from_numpy(rng.integers(-2**31, 2**31, (C, T, srt.TILE)).astype(np.int32)).to(dev)
    got = srt.sort_tiles(key, ch)
    want = srt.sort_tiles_plain(key, ch)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_sort_tiles_rejects_unaligned_channels():
    """K8 copies each channel's tile 16 bytes at a time: channels that do
    not start on a 16-byte boundary raise instead of launching."""
    dev = cuda_device()
    key = torch.zeros((2, srt.TILE), dtype=torch.int32, device=dev)
    ch = torch.zeros(2 * srt.TILE + 1, dtype=torch.int32, device=dev)[1:].view(1, 2, srt.TILE)
    before = srt.LAUNCHES["sort_tiles"]
    with pytest.raises(ValueError):
        srt.sort_tiles(key, ch)
    assert srt.LAUNCHES["sort_tiles"] == before


@pytest.mark.parametrize("frame", ["odd_tiles", "dead_ties"])
def test_sorted_kernels_bit_equal_on_large_frames(frame):
    """The sorted K1 (cap 5), K2 (resume to 24) and K5 (to 24) on 397 tiles
    less 13 lanes: no multiple of the 3 x 132 blocks of 256 an H100 holds at
    once, so a block runs alone in a second wave, and the last tile is
    padded. ``dead_ties``: K2 resumes a state in which 7 of 8 paths are
    dead, so most keys tie at the dead key. Every output bit-equal to the
    unsorted kernel's, and the order record of the last sort bit-equal to
    the sorted plain version's."""
    dev = cuda_device()
    n = 397 * mk.SORT_TILE - 13
    ms = mk.mega_scene(_scene(MESHBOX), 320, 320, dev)
    px, py, seeds = (a[:n].contiguous() for a in _frame(320, dev))
    st, rng = mk.megakernel_start(ms, px, py, seeds, 5 if frame == "odd_tiles" else 2)
    if frame == "dead_ties":
        st = st.clone()
        kill = torch.from_numpy(np.random.default_rng(3).random(n) < 0.875).to(dev)
        st[0, kill] = 0.0
    calls = [(mk.megakernel_resume, mk.megakernel_resume_plain, (st, rng, 24))]
    if frame == "odd_tiles":
        calls += [(mk.megakernel_start, mk.megakernel_start_plain, (px, py, seeds, 5)),
                  (mk.megakernel_tiles, mk.megakernel_tiles_plain, (px, py, seeds, 24))]
    for kernel, plain, args in calls:
        got = kernel(ms, *args, lane_sort=True, lane_order=True)
        _assert_same_sort(got[:2], kernel(ms, *args))
        want = plain(ms, *args, lane_sort=True, lane_order=True)
        _assert_same_sort(got, want)
        pid = got[2][0]
        assert not torch.equal(pid, torch.arange(n, dtype=pid.dtype, device=dev))
    if frame == "dead_ties":
        key = got[2][1]
        assert float((key == 1 << 20).float().mean()) > 0.8


@pytest.mark.parametrize("B,S", [(1, 8), (2, 8), (3, 8), (4, 8), (128, 8), (3, 20)])
def test_reconstruct_chunk_equals_summed_sweeps(B, S):
    """K3 at S = 8 (one launch, a chained chunk's shape; S = 20 takes two
    launches, the second adding to the first's sum) against the same
    kernel's S = 1 calls summed in sweep order, bit for bit, and against the
    plain version (rtol 1e-5 / atol 1e-6), on a 67x131 image (no multiple
    of the tile or of B) with NaN pixels."""
    dev = cuda_device()
    rng = np.random.default_rng(B + S)
    H, W = 67, 131
    color = (rng.random((S, H, W, 3)) * 2).astype(np.float32)
    color[rng.random((S, H, W)) < 1e-2] = np.nan
    normal = rng.standard_normal((S, H, W, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    so = rng.random((S, 2)).astype(np.float32)
    c, n = torch.from_numpy(color).to(dev), torch.from_numpy(normal).to(dev)
    before = prc.LAUNCHES["reconstruct"]
    got = prc.reconstruct(c, n, so, block_size=B)
    assert prc.LAUNCHES["reconstruct"] == before + 1
    want = None
    for s in range(S):
        d = prc.reconstruct(c[s], n[s], so[s], block_size=B)
        want = d if want is None else want + d
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    plain = prc.reconstruct_plain(c, n, so, block_size=B)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(), rtol=1e-5, atol=1e-6)


def _k6_ray_set(kind, cs, dev):
    """K6's edge cases on random rays (torch_port_helpers.random_rays):
    every lane dead; 1% walking, scattered; NaN tmin or tmax on a third of
    the lanes; direction components exactly 0 and -0.0."""
    from torch_port_helpers import sparse_rays

    o, d, tmin, tmax = random_rays(cs, 5000, seed=21)
    if kind == "dead":
        tmax = np.full_like(tmax, -3.0e38)
    elif kind == "sparse":
        o, d, tmin, tmax = sparse_rays((o, d, tmin, tmax), seed=22)
    elif kind == "nan_bounds":
        tmin, tmax = tmin.copy(), tmax.copy()
        tmin[::3] = np.nan
        tmax[1::3] = np.nan
    else:
        d = d.copy()
        d[::2, 0] = 0.0
        d[1::3, 1] = -0.0
        d[::5, 2] = 0.0
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (o, d, tmin, tmax)]


@pytest.mark.parametrize("kind", ["dead", "sparse", "nan_bounds", "zero_dir"])
@pytest.mark.parametrize("mode", ["closest", "any", "inclusive"])
def test_traverse_edge_rays_bit_equal_to_plain(kind, mode):
    """K6 bit-equal to traverse_plain on all 7 channels in all three modes;
    a lane that walks nothing visits no row."""
    dev = cuda_device()
    cs = to_device(_scene(MESHBOX), dev)
    rays = _k6_ray_set(kind, cs, dev)
    kw = {"closest": {}, "any": {"any_hit": True},
          "inclusive": {"any_hit": True, "inclusive": True}}[mode]
    want = pt.traverse_plain(cs.trace_rows, *rays, **kw)
    got = pt.traverse(cs.trace_rows, *rays, **kw)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    walks = rays[3] >= rays[2]
    assert (want[6][~walks] == 0).all()
    if kind in ("sparse", "zero_dir"):
        assert (want[1][walks] > 0).any()


def test_traverse_rejects_unaligned_rows():
    """K6 reads a row's columns 16 bytes at a time: a table that does not
    start on a 16-byte boundary is refused."""
    dev = cuda_device()
    cs = to_device(_scene(MESHBOX_SMALL), dev)
    o, d, tmin, tmax = (torch.from_numpy(x).to(dev) for x in random_rays(cs, 64, seed=1))
    flat = torch.empty(cs.trace_rows.numel() + 1, device=dev)
    shifted = flat[1:].view(cs.trace_rows.shape)
    shifted.copy_(cs.trace_rows)
    with pytest.raises(ValueError):
        pt.traverse(shifted, o, d, tmin, tmax)


@pytest.mark.parametrize("S", [1, 8])
@pytest.mark.parametrize("H,W,B", [(768, 1024, 128), (67 + 128, 131, 64)])
def test_weighted_reconstruct_kernel_matches_plain(H, W, B, S):
    """K3's weighted mode (a multi-device band's canvas: the band's rows
    between B rows of zero padding at weight 0, NaN pixels in the band)
    against its plain version (rtol 1e-5 / atol 1e-6); its S = 8 launch
    bit-equal to its S = 1 launches summed in sweep order; weight 1
    everywhere bit-equal to the unweighted kernel; each counted apart."""
    dev = cuda_device()
    rng = np.random.default_rng(H + S)
    band = H - 2 * B
    pad = lambda a: np.pad(a, [(0, 0), (B, B)] + [(0, 0)] * (a.ndim - 2))
    color = (rng.random((S, band, W, 3)) * 2).astype(np.float32)
    color[rng.random((S, band, W)) < 1e-3] = np.nan
    normal = rng.standard_normal((S, band, W, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    so = rng.random((S, 2)).astype(np.float32)
    c, n = (torch.from_numpy(pad(a)).to(dev) for a in (color, normal))
    w = torch.from_numpy(pad(np.ones((1, band, W), np.float32))[0]).to(dev)
    before = dict(prc.LAUNCHES)
    got = prc.reconstruct(c, n, so, block_size=B, sample_weight=w)
    assert prc.LAUNCHES["reconstruct_weighted"] == before["reconstruct_weighted"] + 1
    assert prc.LAUNCHES["reconstruct"] == before["reconstruct"]
    plain = prc.reconstruct_plain(c, n, so, block_size=B, sample_weight=w)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(), rtol=1e-5, atol=1e-6)
    assert not got[:B].any() and not got[B + band + prc.R:].any()
    if S > 1:
        want = None
        for s in range(S):
            d = prc.reconstruct(c[s], n[s], so[s], block_size=B, sample_weight=w)
            want = d if want is None else want + d
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    ones = torch.ones_like(w)
    assert torch.equal(prc.reconstruct(c, n, so, block_size=B, sample_weight=ones).view(torch.int32),
                       prc.reconstruct(c, n, so, block_size=B).view(torch.int32))


@pytest.mark.parametrize("chain", [1, 4])
def test_two_bands_on_one_card_match_single(chain):
    """MegaMultiChipRenderer over [cuda:0, cuda:0]: two row bands, each on
    its own stream of the one card (K1/K2 or K4/K2, weighted K3), against
    the single Renderer at rtol 1e-4 / atol 1e-5; the sync
    MultiChipRenderer over the same two entries against the single sync
    film at rtol 5e-4 / atol 5e-5."""
    from hijiki_tpu_torch.parallel.multichip import MegaMultiChipRenderer, MultiChipRenderer

    cuda_device()
    cs = _scene(MESHBOX)
    cfg = RenderConfig(width=256, height=256, spp=4, block_size=128, chain_sweeps=chain)
    single = Renderer(cs, cfg, device="cuda")
    single.render()
    before = dict(prc.LAUNCHES)
    bands = MegaMultiChipRenderer(cs, cfg, devices=["cuda:0", "cuda:0"])
    m = bands.render()
    assert m["devices"] == 2 and m["wave_overflow"] == 0 and m["chain_chunk_sweeps"] == chain
    assert prc.LAUNCHES["reconstruct"] == before["reconstruct"]
    assert prc.LAUNCHES["reconstruct_weighted"] == before["reconstruct_weighted"] + 2 * 4 // chain
    np.testing.assert_allclose(bands.film.cpu().numpy(), single.film.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    if chain == 1:
        sync = dict(width=128, height=128, spp=1, block_size=64, driver="sync", max_bounces=50)
        one = Renderer(cs, RenderConfig(**sync), device="cuda")
        one.render()
        two = MultiChipRenderer(cs, RenderConfig(**sync), devices=["cuda:0", "cuda:0"])
        two.render()
        np.testing.assert_allclose(two.film.cpu().numpy(), one.film.cpu().numpy(),
                                   rtol=5e-4, atol=5e-5)


# the trace-row formats of the megakernel: (packed_leaf, boxes, the
# dedicated shadow table) on meshbox_small + spheres (octant tables on)
FORMATS = {"slim": (1, True, False), "packed3": (3, True, False), "packed4": (4, True, False),
           "packed12": (12, True, False), "shadow_tbl": (0, True, True),
           "noboxes": (0, False, False), "boxes": (0, True, False)}


def _format_scene(config, S, dev):
    packed, boxes, tbl = FORMATS[config]
    s = load_obj_scene(MESHBOX_SMALL)
    s.put_cbox_spheres()
    cs = compile_scene(s, packed_leaf=packed, shadow_vis_boxes=boxes)
    assert cs.mega_packed_static == packed and cs.mega_num_tables_static == 8
    return mk.launch_scene(mk.mega_scene(cs, S, S, dev), shadow_tbl=tbl)


@pytest.mark.parametrize("config", list(FORMATS))
def test_formats_kernels_match_twin(config):
    """K1 (cap 5), K2 (resume to 24), K5 (to 24) and K4 (3 samples, chain
    cap 8) on each packed format, with the boxes, with the shadow table and
    with neither, against their twins: every output bit for bit (the twin
    rounds as the kernel does); the sorted K1/K2/K5 bit-equal to the
    unsorted kernels."""
    dev = cuda_device()
    S = 64
    ms = _format_scene(config, S, dev)
    px, py, seeds = _frame(S, dev)
    before = dict(mk.LAUNCHES)
    k1 = mk.megakernel_start(ms, px, py, seeds, 5)
    k2 = mk.megakernel_resume(ms, *k1, 24)
    k5 = mk.megakernel_tiles(ms, px, py, seeds, 24)
    pxs = torch.stack([px, px + 0.25, px - 0.25])
    pys = torch.stack([py, py - 0.125, py + 0.125])
    sds = torch.stack([seeds, seeds + 1, seeds + 977])
    k4 = mk.megakernel_start_chained(ms, pxs, pys, sds, 8)
    for name in ("mk_start", "mk_resume", "mk_tiles", "mk_start_chained"):
        assert mk.LAUNCHES[name] == before[name] + 1
    bits = lambda ts: [t.view(torch.int32) for t in ts]
    for got, want in ((k1, mk.megakernel_start_plain(ms, px, py, seeds, 5)),
                      (k2, mk.megakernel_resume_plain(ms, *k1, 24)),
                      (k5, mk.megakernel_tiles_plain(ms, px, py, seeds, 24)),
                      (k4, mk.megakernel_start_chained_plain(ms, pxs, pys, sds, 8))):
        assert all(torch.equal(a, b) for a, b in zip(bits(got), bits(want)))
    for fn, args, un in ((mk.megakernel_start, (px, py, seeds, 5), k1),
                         (mk.megakernel_resume, (*k1, 24), k2),
                         (mk.megakernel_tiles, (px, py, seeds, 24), k5)):
        got = fn(ms, *args, lane_sort=True)
        assert all(torch.equal(a, b) for a, b in zip(bits(got), bits(un)))


def test_boxes_and_shadow_table_keep_the_film_on_card():
    """On the full meshbox, render_waves_chained with the boxes, with the
    shadow table and with neither: every output bit-equal but rows, which
    both lower."""
    dev = cuda_device()
    S = 128
    ms = mk.mega_scene(_scene(MESHBOX), S, S, dev)
    px, py, seeds = _frame(S, dev)
    pxs = torch.stack([px, px + 0.25])
    pys = torch.stack([py, py - 0.125])
    sds = torch.stack([seeds, seeds + 977])
    off = mk.render_waves_chained(ms, pxs, pys, sds, max_bounces=64, shadow_vis=False)
    for kw in ({}, {"shadow_tbl": True}):
        on = mk.render_waves_chained(ms, pxs, pys, sds, max_bounces=64, **kw)
        for i in (0, 1, 2, 3, 5, 7):
            assert torch.equal(on[i].view(torch.int32), off[i].view(torch.int32)), (kw, i)
        assert float(on[6].sum()) < float(off[6].sum())


def test_wrapper_rejects_unaligned_shadow_table():
    dev = cuda_device()
    ms = _format_scene("shadow_tbl", 32, dev)
    flat = torch.zeros(ms.shadow_rows.numel() + 1, device=dev)
    shifted = flat[1:].view_as(ms.shadow_rows)
    shifted.copy_(ms.shadow_rows)
    import dataclasses

    bad = dataclasses.replace(ms, shadow_rows=shifted)
    px, py, seeds = _frame(32, dev)
    with pytest.raises(ValueError, match="16-byte"):
        mk.megakernel_start(bad, px, py, seeds, 5)


CACHE_FORMATS = ("boxes", "noboxes", "slim", "packed3", "packed4", "packed12")


@pytest.mark.parametrize("config", CACHE_FORMATS)
def test_cache_kernels_match_twin(config):
    """The occlusion cache's instantiations (kCache) of K1 (cap 5), K2
    (resume to 24), K5 (to 24) and K4 (3 samples, chain cap 8) on each
    format: every output, rows included, bit-equal to the cache-on twin;
    every output but rows bit-equal to the cache-off kernels, some path's
    rows lower; the sorted K1/K2/K5 with the cache bit-equal to the unsorted
    ones, their order records to the plain versions'."""
    dev = cuda_device()
    S = 64
    off_ms = _format_scene(config, S, dev)
    ms = mk.launch_scene(off_ms, shadow_cache=True)
    px, py, seeds = _frame(S, dev)
    pxs = torch.stack([px, px + 0.25, px - 0.25])
    pys = torch.stack([py, py - 0.125, py + 0.125])
    sds = torch.stack([seeds, seeds + 1, seeds + 977])
    bits = lambda ts: [t.view(torch.int32) for t in ts]
    rows = mk._STATE_CH.index("rows")
    keep = [i for i in range(mk.N_STATE) if i != rows]
    before = dict(mk.LAUNCHES)
    k1 = mk.megakernel_start(ms, px, py, seeds, 5)
    k2 = mk.megakernel_resume(ms, *k1, 24)
    k5 = mk.megakernel_tiles(ms, px, py, seeds, 24)
    k4 = mk.megakernel_start_chained(ms, pxs, pys, sds, 8)
    for name in ("mk_start", "mk_resume", "mk_tiles", "mk_start_chained"):
        assert mk.LAUNCHES[name + "_cache"] == before[name + "_cache"] + 1
        assert mk.LAUNCHES[name] == before[name]
    for got, want in ((k1, mk.megakernel_start_plain(ms, px, py, seeds, 5)),
                      (k2, mk.megakernel_resume_plain(ms, *k1, 24)),
                      (k5, mk.megakernel_tiles_plain(ms, px, py, seeds, 24)),
                      (k4, mk.megakernel_start_chained_plain(ms, pxs, pys, sds, 8))):
        assert all(torch.equal(a, b) for a, b in zip(bits(got), bits(want)))
    off1 = mk.megakernel_start(off_ms, px, py, seeds, 5)
    assert torch.equal(k1[0][keep].view(torch.int32), off1[0][keep].view(torch.int32))
    assert torch.equal(k1[1], off1[1]) and float(k1[0][rows].sum()) < float(off1[0][rows].sum())
    off5 = mk.megakernel_tiles(off_ms, px, py, seeds, 24)
    assert all(torch.equal(a, b) for a, b in zip(bits(k5), bits(off5)))
    for fn, args, un in ((mk.megakernel_start, (px, py, seeds, 5), k1),
                         (mk.megakernel_resume, (*k1, 24), k2),
                         (mk.megakernel_tiles, (px, py, seeds, 24), k5)):
        got = fn(ms, *args, lane_sort=True, lane_order=True)
        plain = {mk.megakernel_start: mk.megakernel_start_plain,
                 mk.megakernel_resume: mk.megakernel_resume_plain,
                 mk.megakernel_tiles: mk.megakernel_tiles_plain}[fn]
        want = plain(ms, *args, lane_sort=True, lane_order=True)
        assert all(torch.equal(a, b) for a, b in zip(bits(got[:2]), bits(un)))
        assert torch.equal(got[2], want[2])


# packed prim rows edited so that the walk meets the cases the tournament
# and the any-hit accept must get right: ``rotate`` moves each prim one
# place on (the last, often a pad, to the front: a pad before the real
# hits, an accept at prim 0 falls on prim 1, at n - 2 on the last),
# ``tie`` copies prim 0 over prim 1 (two prims at the same t; format 4
# keeps prim 1's own slot, so the wrong winner shows), ``last`` leaves
# prim 0 alone at the last place and zero pads before it (every accept on
# the last prim)
PACKED_EDITS = ("rotate", "tie", "last")


def _edit_packed(rows, fmt, n_walk, how):
    """A copy of the packed table ``rows`` (format ``fmt``) whose first
    ``n_walk`` rows' prim rows are edited as ``how`` says (PACKED_EDITS)."""
    rows = rows.clone()
    head = rows[:n_walk]
    prim = head[:, 9] >= 0.0
    ncol = 13 if fmt == 4 else 9
    cols = [torch.arange(B, B + ncol, device=rows.device) for B in mk._PACKED_BASES[fmt]]
    blocks = [head[prim][:, c] for c in cols]  # each prim's columns, before the edit
    n = len(blocks)
    if how == "rotate":
        new = [blocks[(k - 1) % n] for k in range(n)]
    elif how == "tie":
        new = list(blocks)
        new[1] = blocks[0].clone()
        if fmt == 4:
            new[1][:, 12] = blocks[1][:, 12]
    else:
        new = [torch.zeros_like(b) for b in blocks[:-1]] + [blocks[0]]
        if fmt == 4:
            for k in range(n - 1):
                new[k][:, 12] = blocks[k][:, 12]
    sub = head[prim]
    for c, b in zip(cols, new):
        sub[:, c] = b
    head[prim] = sub
    return rows


@pytest.mark.parametrize("how", PACKED_EDITS)
@pytest.mark.parametrize("config", ["packed3", "packed4", "packed12", "shadow_tbl"])
def test_packed_walks_match_plain_on_edited_rows(config, how):
    """Every packed walk on tables whose prim rows put two prims at one t,
    a pad beside a real hit, and the any-hit accept on the second and on
    the last prim (``_edit_packed``): K10b (test and notest, G 1 and 32; not
    on the shadow table, which it does not walk), K1 (cap 5), K2 (to 24),
    K5 (to 24), K4 (3 samples) and the sorted K1/K2/K5, with the occlusion
    cache off and on (the shadow table: off, its any-hit walk is the
    edited one), every output bit-equal to the plain version."""
    import dataclasses

    from hijiki_tpu_torch.probes import walk_probe as W

    dev = cuda_device()
    S = 64
    ms = _format_scene(config, S, dev)
    if config == "shadow_tbl":
        ms = dataclasses.replace(ms, shadow_rows=_edit_packed(ms.shadow_rows, 3, ms.shadow_n, how))
    else:
        ms = dataclasses.replace(ms, rows=_edit_packed(ms.rows, ms.packed, ms.ntab * ms.tbl_rows,
                                                       how))
        cs = compile_scene(load_obj_scene(MESHBOX_SMALL))
        for rays in ("camera", "random"):
            o, d = W.ray_set(rays, cs, S * S, dev, frame=S)
            for test in (True, False):
                for g in (1, 32):
                    got = W.walk_isolate(ms, ms.rows, o, d, test=test, group=g, iters=2)
                    want = W.walk_isolate_plain(ms, ms.rows, o, d, test=test, group=g)
                    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                               for a, b in zip(got, want)), (rays, test, g)
    px, py, seeds = _frame(S, dev)
    pxs = torch.stack([px, px + 0.25, px - 0.25])
    pys = torch.stack([py, py - 0.125, py + 0.125])
    sds = torch.stack([seeds, seeds + 1, seeds + 977])
    bits = lambda ts: [t.view(torch.int32) for t in ts]
    plain = {mk.megakernel_start: mk.megakernel_start_plain,
             mk.megakernel_resume: mk.megakernel_resume_plain,
             mk.megakernel_tiles: mk.megakernel_tiles_plain}
    for cache in ((False,) if config == "shadow_tbl" else (False, True)):
        m = mk.launch_scene(ms, shadow_tbl=config == "shadow_tbl", shadow_cache=cache)
        k1 = mk.megakernel_start(m, px, py, seeds, 5)
        k2 = mk.megakernel_resume(m, *k1, 24)
        k5 = mk.megakernel_tiles(m, px, py, seeds, 24)
        k4 = mk.megakernel_start_chained(m, pxs, pys, sds, 8)
        for got, want in ((k1, mk.megakernel_start_plain(m, px, py, seeds, 5)),
                          (k2, mk.megakernel_resume_plain(m, *k1, 24)),
                          (k5, mk.megakernel_tiles_plain(m, px, py, seeds, 24)),
                          (k4, mk.megakernel_start_chained_plain(m, pxs, pys, sds, 8))):
            assert all(torch.equal(a, b) for a, b in zip(bits(got), bits(want))), cache
        for fn, args, un in ((mk.megakernel_start, (px, py, seeds, 5), k1),
                             (mk.megakernel_resume, (*k1, 24), k2),
                             (mk.megakernel_tiles, (px, py, seeds, 24), k5)):
            got = fn(m, *args, lane_sort=True, lane_order=True)
            want = plain[fn](m, *args, lane_sort=True, lane_order=True)
            assert all(torch.equal(a, b) for a, b in zip(bits(got[:2]), bits(un))), cache
            assert torch.equal(got[2], want[2]), cache


def test_skip_all_kernels_match_twin():
    """The skip-all probe (a run-time scene word: no instantiation of its
    own) in K1 (cap 5) and K2 (resume to 24) against their twins, every
    output bit for bit; the paths walk no shadow row (fewer rows), and the
    film and RNG of render_waves(shadow_skip_all=True) are its twin's."""
    dev = cuda_device()
    S = 64
    ms = _format_scene("boxes", S, dev)
    sk = mk.launch_scene(ms, shadow_skip_all=True)
    px, py, seeds = _frame(S, dev)
    bits = lambda ts: [t.view(torch.int32) for t in ts]
    before = dict(mk.LAUNCHES)
    k1 = mk.megakernel_start(sk, px, py, seeds, 5)
    k2 = mk.megakernel_resume(sk, *k1, 24)
    assert mk.LAUNCHES["mk_start"] == before["mk_start"] + 1
    assert mk.LAUNCHES["mk_start_cache"] == before["mk_start_cache"]
    assert all(torch.equal(a, b) for a, b in
               zip(bits(k1), bits(mk.megakernel_start_plain(sk, px, py, seeds, 5))))
    assert all(torch.equal(a, b) for a, b in
               zip(bits(k2), bits(mk.megakernel_resume_plain(sk, *k1, 24))))
    rows = mk._STATE_CH.index("rows")
    fair = mk.megakernel_start(ms, px, py, seeds, 5)
    assert torch.equal(k1[1], fair[1]) and float(k1[0][rows].sum()) < float(fair[0][rows].sum())


def test_drivers_meet_oracle_bar_on_card():
    """Phase (r) of chip_smoke.py at 32x32 x 8 spp: the chained (K4 + K2),
    unchained (K1 + K2) and sync (K6) drivers on the card against the
    native scalar oracle at equal seeds, each to the bar (raw MSE < 1e-4,
    at most 1% of the pixels divergent, trimmed MSE <= 1e-8), as is the
    chained film against the sync film."""
    import chip_smoke

    dev = cuda_device()
    s = load_obj_scene(MESHBOX, backend="native")
    s.put_cbox_spheres()
    cs = compile_scene(s)
    side, spp = 32, 8
    seeds, offsets = chip_smoke.equal_seed_inputs(side, spp, 0)
    before = {**mk.LAUNCHES, **pt.LAUNCHES}
    films = chip_smoke.driver_films(cs, seeds, offsets, side, dev, chain=spp)
    for k in ("mk_start_chained", "mk_resume", "mk_start"):
        assert mk.LAUNCHES[k] > before[k], k
    assert pt.LAUNCHES["traverse"] > before["traverse"]
    oracle = chip_smoke.oracle_film(cs, seeds, offsets, side)
    for a, b in (("oracle", "chained"), ("oracle", "unchained"), ("oracle", "sync"),
                 ("chained", "sync"), ("oracle", "sync_mega_camera")):
        x, y = (oracle if a == "oracle" else films[a]), films[b]
        r = chip_smoke.readings(x, y)
        print(f"{a}-{b}: raw MSE {r[0]:.3e}, divergent {r[1]}/{side * side}, trimmed {r[2]:.3e}")
        assert chip_smoke.breaks_bar(r, side * side) == "", (a, b, r)
