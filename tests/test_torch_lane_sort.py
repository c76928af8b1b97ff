"""The mega driver's lane sort (``--sort-lanes``; K7 inside the sorted
K1/K2/K5) on the CPU: the sorted plain versions against the unsorted ones,
the port's sorted ``render_waves`` against hijiki_tpu's
``render_waves(lane_sort=True)`` in interpret mode, and the Renderer and
CLI with the flag.

Bounds: the sort permutes whole paths and each lane traces alone, so every
sorted output is bit-equal to the unsorted one (int32 views: NaN included,
the ``segs`` and ``rows`` counters too). Against the TPU kernel the bounds
of tests/test_torch_megakernel.py hold (RNG state bit-equal and radiance
within 2e-3 on >= 99.5% of paths). Small sizes (32x32, max_bounces <= 8):
the plain sort is 36 stages of tensor ops after every pass. (The CUDA
kernels are held against these on the card in tests/test_torch_cuda.py.)"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hijiki_tpu.ops import pallas_megakernel as jmk
from hijiki_tpu_torch import cli
from hijiki_tpu_torch.ops import megakernel as mk
from hijiki_tpu_torch.render.renderer import RenderConfig, Renderer
from hijiki_tpu_torch.utils.exr import read_exr
from test_torch_megakernel import _both, _inputs, _tt, assert_paths_agree
from torch_port_helpers import MESHBOX_SMALL, port_scene

W = H = 32


def bits(ts):
    """float tensors as their int32 bits (NaN == NaN); others as they are"""
    return [t.view(torch.int32) if t.is_floating_point() else t for t in ts]


def assert_bit_equal(got, want):
    for g, w in zip(bits(got), bits(want)):
        assert torch.equal(g, w)


@pytest.fixture(scope="module", params=["meshbox_small", "mixed"])
def scenes(request):
    return _both(request.param)


def test_sorted_twins_equal_unsorted(scenes):
    """K1 (cap 3), K2 (resume to 8) and K5 (to 8; on 1000 lanes, so the last
    tile is padded with dead paths): sorted == unsorted on every output."""
    _, _, ms = scenes
    px, py, seeds = _tt(*_inputs())
    k1 = mk.megakernel_start(ms, px, py, seeds, 3)
    assert_bit_equal(mk.megakernel_start(ms, px, py, seeds, 3, lane_sort=True), k1)
    assert_bit_equal(mk.megakernel_resume(ms, *k1, 8, lane_sort=True),
                     mk.megakernel_resume(ms, *k1, 8))
    part = [a[:1000].contiguous() for a in (px, py, seeds)]
    assert_bit_equal(mk.megakernel_tiles(ms, *part, 8, lane_sort=True),
                     mk.megakernel_tiles(ms, *part, 8))
    assert float(k1[0][0].sum()) > 0  # some paths still alive at the cap: K2 had work


def test_lane_sort_permutes_whole_paths(scenes):
    """One pass of the plain lane sort on a state two bounces in: in each
    SORT_TILE-lane tile the keys come out ascending, the path ids are a
    permutation of the tile's own lanes, and every channel moved with its
    path (the value now at lane i is the one path pid[i] held)."""
    _, _, ms = scenes
    st, rng = mk.megakernel_start(ms, *_tt(*_inputs()), 2)
    n = st.shape[1]
    s = mk._unpack(st, rng)
    s["pid"] = torch.arange(n, dtype=torch.int32)
    out = mk._lane_sort(ms, s, torch.arange(n // mk.SORT_TILE))
    key = mk.lane_sort_key(ms, out).view(-1, mk.SORT_TILE)
    assert (key[:, 1:] >= key[:, :-1]).all()
    assert (key == 1 << 20).any() and (key < 1 << 20).any()  # dead and live paths
    pid = out["pid"].long()
    assert torch.equal(pid // mk.SORT_TILE, torch.arange(n) // mk.SORT_TILE)
    assert torch.equal(torch.sort(pid).values, torch.arange(n))
    assert not torch.equal(pid, torch.arange(n))
    assert_bit_equal([out[ch] for ch in s if ch != "pid"], [s[ch][pid] for ch in s if ch != "pid"])


def test_lane_order_records_the_last_sort(scenes):
    """lane_order: the path id at each lane after its tile's last sort and
    that path's key. Per tile the ids are a permutation of the tile's own
    paths (the padded ones of the last tile included), the keys ascend and
    equal lane_sort_key of the path's final state; the outputs are those of
    the call without the record. The sort moved paths: the order is no
    tile's identity."""
    _, _, ms = scenes
    px, py, seeds = (a[:1000].contiguous() for a in _tt(*_inputs()))
    n, t = 1000, mk.SORT_TILE
    k1 = mk.megakernel_start(ms, px, py, seeds, 3)
    for got, plain in ((mk.megakernel_start(ms, px, py, seeds, 3, lane_sort=True, lane_order=True),
                        k1),
                       (mk.megakernel_resume(ms, *k1, 8, lane_sort=True, lane_order=True),
                        mk.megakernel_resume(ms, *k1, 8))):
        assert_bit_equal(got[:2], plain)
        order = got[2]
        assert order.shape == (2, n) and order.dtype == torch.int32
        pid, key = order[0].long(), order[1]
        lane = torch.arange(n)
        assert torch.equal(pid // t, lane // t)
        assert torch.equal(torch.sort(pid[: n // t * t]).values, lane[: n // t * t])
        assert not torch.equal(pid, lane)
        assert (key[1:] >= key[:-1])[(lane[1:] % t) != 0].all()
        final = torch.cat([mk.lane_sort_key(ms, mk._unpack(*got[:2])),
                           torch.full(((-n) % t,), 1 << 20, dtype=torch.int32)])
        assert torch.equal(key, final[pid])
    with pytest.raises(ValueError, match="lane_sort"):
        mk.megakernel_start(ms, px, py, seeds, 3, lane_order=True)


def test_sort_tile_matches_the_kernel_source():
    """SORT_TILE is the sorted kernels' kSortTile: the order record of the
    plain version and the kernel's agree only at one tile."""
    src = (Path(mk.__file__).parents[1] / "csrc" / "megakernel.cu").read_text()
    assert f"constexpr int kSortTile = {mk.SORT_TILE};" in src


def test_sorted_render_waves_matches_tpu_kernel(scenes):
    """The port's sorted render_waves against JAX's render_waves(lane_sort=
    True) in interpret mode, and bit-equal to the port's unsorted one."""
    _, jcs, ms = scenes
    px, py, seeds = _inputs()
    kw = dict(max_bounces=8, phase_bounces=(3, 6))
    jw = jmk.render_waves(jcs, jnp.asarray(px), jnp.asarray(py), jnp.asarray(seeds), width=W,
                          height=H, lane_sort=True, interpret=True, **kw)
    tw = mk.render_waves(ms, *_tt(px, py, seeds), lane_sort=True, **kw)
    assert int(jw[4]) == 0 and int(tw[4]) == 0
    assert_paths_agree(jw[3], tw[3], jw[0], tw[0])
    same = np.asarray(jw[3]) == tw[3].numpy().astype(np.uint32)
    np.testing.assert_array_equal(tw[5].numpy()[same], np.asarray(jw[5])[same])
    assert_bit_equal(tw, mk.render_waves(ms, *_tt(px, py, seeds), **kw))


def test_sorted_renderer_film_equals_unsorted():
    """Renderer(driver="mega", sort_lanes=True): unchained (chaining is off
    by rule), no launch counted on the CPU (the plain versions run), the
    film bit-equal to the unsorted render."""
    from hijiki_tpu.scene.compile import compile_scene as j_compile
    from hijiki_tpu.scene.obj import load_obj_scene as j_load

    s = j_load(MESHBOX_SMALL)
    s.put_cbox_spheres()
    cs = port_scene(j_compile(s, shadow_vis_boxes=False))
    cfg = dict(width=W, height=H, spp=2, block_size=64, seed=3, max_bounces=8, driver="mega")
    plain = Renderer(cs, RenderConfig(**cfg), device="cpu")
    plain.render()
    before = dict(mk.LAUNCHES)
    r = Renderer(cs, RenderConfig(**cfg, sort_lanes=True), device="cpu")
    m = r.render()
    assert m["chain_chunk_sweeps"] == 1 and mk.LAUNCHES == before
    assert torch.equal(r.film, plain.film)
    assert r.image().mean() > 0


def test_sorted_renderer_resumes_unsorted_checkpoint(tmp_path):
    """sort_lanes changes no film, so it is not one of the fields a resumed
    render must match: a render checkpointed unsorted resumes sorted."""
    _, jcs, _ = _both("meshbox_small")
    cs = port_scene(jcs)
    cfg = dict(width=W, height=H, block_size=64, seed=4, max_bounces=6, driver="mega")
    ck = str(tmp_path / "ck.npz")
    half = Renderer(cs, RenderConfig(**cfg, spp=1), device="cpu")
    half.render()
    half.save_checkpoint(ck)
    resumed = Renderer.resume_checkpoint(cs, ck, RenderConfig(**cfg, spp=2, sort_lanes=True),
                                         device="cpu")
    resumed.render()
    full = Renderer(cs, RenderConfig(**cfg, spp=2), device="cpu")
    full.render()
    assert resumed.sweeps_done == 2 and torch.equal(resumed.film, full.film)


def test_cli_mega_sort_lanes_bit_equal(tmp_path):
    """``--driver mega --sort-lanes`` renders the same EXR, bit for bit."""
    base = [MESHBOX_SMALL, "--put-cbox-spheres", "--use-bvh", "--driver", "mega", "-w", "32",
            "-H", "24", "-s", "2", "--max-bounces", "8", "--device", "cpu"]
    a, b = tmp_path / "a.exr", tmp_path / "b.exr"
    assert cli.main(base + ["-o", str(a)]) == 0
    assert cli.main(base + ["--sort-lanes", "-o", str(b)]) == 0
    ia, ib = read_exr(str(a)), read_exr(str(b))
    assert np.isfinite(ib).all() and ib.mean() > 0
    np.testing.assert_array_equal(ia.view(np.int32), ib.view(np.int32))


def test_chained_sort_lanes_refused():
    """Chaining needs the unsorted launches (as in JAX): an explicit
    chain_sweeps > 1 with sort_lanes is an error, auto resolves to 1."""
    _, jcs, _ = _both("meshbox_small")
    with pytest.raises(ValueError, match="sort-lanes"):
        Renderer(port_scene(jcs), RenderConfig(width=16, height=16, spp=2, sort_lanes=True,
                                               chain_sweeps=2), device="cpu").render()
