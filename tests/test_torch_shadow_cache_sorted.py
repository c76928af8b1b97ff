"""The occlusion cache in the lane-sorted and the chained launches' twins:
the lane-sorted twin with the cache equals the unsorted one with it (the
prediction moves with its path through the sort), and the chained launch
with the cache equals separate cache-on sweeps (a respawned slot's
prediction starts at -1)."""

import pytest
import torch

from hijiki_tpu_torch.ops import megakernel as mk
from test_torch_shadow_cache_formats import BOUNCES, CONFIGS, _bits, _inputs, _scene


@pytest.mark.parametrize("config", ["classic", "packed4"])
def test_sorted_cache_equals_unsorted_cache(config):
    """The sorted K1/K2/K5 twins with the cache: every output the unsorted
    cache-on twin's, rows included, and their order records the cache-off
    sorted twin's (the cache moves no path's key)."""
    ms = _scene(*CONFIGS[config])
    on = mk.launch_scene(ms, shadow_cache=True)
    px, py, seeds = _inputs()
    un = mk.megakernel_start(on, px, py, seeds, BOUNCES)
    so = mk.megakernel_start(on, px, py, seeds, BOUNCES, lane_sort=True, lane_order=True)
    ref = mk.megakernel_start(ms, px, py, seeds, BOUNCES, lane_sort=True, lane_order=True)
    assert torch.equal(_bits(so[0]), _bits(un[0])) and torch.equal(so[1], un[1])
    assert torch.equal(so[2], ref[2])
    st, rng = mk.megakernel_start(ms, px, py, seeds, 5)
    a = mk.megakernel_resume(on, st, rng, BOUNCES)
    b = mk.megakernel_resume(on, st, rng, BOUNCES, lane_sort=True)
    assert torch.equal(_bits(a[0]), _bits(b[0])) and torch.equal(a[1], b[1])
    ta = mk.megakernel_tiles(on, px, py, seeds, BOUNCES)
    tb = mk.megakernel_tiles(on, px, py, seeds, BOUNCES, lane_sort=True)
    assert torch.equal(_bits(ta[0]), _bits(tb[0])) and torch.equal(ta[1], tb[1])


def test_chained_cache_equals_separate_sweeps():
    """The chained launch with the cache: each sweep's film, RNG and rows
    those of a cache-on render_waves of that sweep alone (a respawned
    slot's prediction starts at -1, as a fresh sweep's does)."""
    ms = _scene(0, True)
    px, py, seeds = _inputs()
    pxs = torch.stack([px, px + 0.25])
    pys = torch.stack([py, py - 0.125])
    sds = torch.stack([seeds, seeds + 977])
    ch = mk.render_waves_chained(ms, pxs, pys, sds, max_bounces=BOUNCES, shadow_cache=True)
    rows = 0.0
    for k in range(2):
        one = mk.render_waves(ms, pxs[k], pys[k], sds[k], max_bounces=BOUNCES,
                              phase_bounces=(8, 48), phase_shrink=(4, 4), shadow_cache=True)
        for i, j in ((0, 0), (2, 2), (3, 3), (5, 5)):  # total, depth, RNG, segs
            assert torch.equal(_bits(ch[i][k]), _bits(one[j])), (k, i)
        rows = rows + one[6]
    assert torch.equal(ch[6], rows)
