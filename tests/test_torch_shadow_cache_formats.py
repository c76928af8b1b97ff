"""The occlusion cache within the port, on every trace-row format: the
cache-on twin equals the cache-off twin bit for bit in every output but the
``rows`` counter (the walk's own accept verifies each prediction, so every
occluded flag is the cache-off one), and some path's ``rows`` differ (a
cache that never verifies would not). The sorted and chained launches with
the cache: tests/test_torch_shadow_cache_sorted.py. The CUDA kernels are
held to these twins on the card (tests/test_torch_cuda.py, chip_smoke.py
phase 4c)."""

import numpy as np
import pytest
import torch

from hijiki_tpu_torch.ops import megakernel as mk
from hijiki_tpu_torch.scene.compile import compile_scene
from hijiki_tpu_torch.scene.obj import load_obj_scene
from torch_port_helpers import MESHBOX_SMALL, frame_inputs

W = H = 32
BOUNCES = 12
# (packed_leaf, shadow-visibility boxes)
CONFIGS = {"classic": (0, True), "noboxes": (0, False), "slim": (1, True),
           "packed3": (3, True), "packed4": (4, True), "packed12": (12, True)}
ROWS = mk._STATE_CH.index("rows")


def _scene(packed, boxes):
    s = load_obj_scene(MESHBOX_SMALL)
    s.put_cbox_spheres()
    return mk.mega_scene(compile_scene(s, packed_leaf=packed, shadow_vis_boxes=boxes), W, H, "cpu")


def _inputs():
    px, py, seeds = frame_inputs(W, H, 0.37, 0.61, 2654435761)
    return torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(seeds.view(np.int32))


def _bits(t):
    return t.contiguous().view(torch.int32)


def _equal_but_rows(on, off):
    """Two packed states, (state, rng): every channel but rows and the RNG
    bit-equal; returns the rows channels."""
    keep = [i for i in range(mk.N_STATE) if i != ROWS]
    assert torch.equal(_bits(on[0][keep]), _bits(off[0][keep]))
    assert torch.equal(on[1], off[1])
    return on[0][ROWS], off[0][ROWS]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_cache_changes_only_rows(config):
    ms = _scene(*CONFIGS[config])
    px, py, seeds = _inputs()
    on_ms = mk.launch_scene(ms, shadow_cache=True)
    off = mk.megakernel_start(ms, px, py, seeds, BOUNCES)
    mk.reset_pretest_counts()
    on = mk.megakernel_start(on_ms, px, py, seeds, BOUNCES)
    tried, verified = mk.pretest_counts()
    assert verified > 0, f"none of {tried} predictions tested verified: the cache never answered"
    r_on, r_off = _equal_but_rows(on, off)
    assert not torch.equal(r_on, r_off), "no path's rows moved"
    # K2 from a cap-5 state, K5 to the cap: the same, cache on against off
    st, rng = mk.megakernel_start(ms, px, py, seeds, 5)
    _equal_but_rows(mk.megakernel_resume(on_ms, st, rng, BOUNCES),
                    mk.megakernel_resume(ms, st, rng, BOUNCES))
    t_on = mk.megakernel_tiles(on_ms, px, py, seeds, BOUNCES)
    t_off = mk.megakernel_tiles(ms, px, py, seeds, BOUNCES)
    assert torch.equal(_bits(t_on[0]), _bits(t_off[0])) and torch.equal(t_on[1], t_off[1])
    # the drivers: render_waves, every output but rows
    w_on = mk.render_waves(ms, px, py, seeds, max_bounces=BOUNCES, shadow_cache=True)
    w_off = mk.render_waves(ms, px, py, seeds, max_bounces=BOUNCES)
    for i in (0, 1, 2, 3, 5, 7):  # total, normal, depth, RNG, segs, albedo
        assert torch.equal(_bits(w_on[i]), _bits(w_off[i])), i
    assert int(w_on[4]) == int(w_off[4]) == 0
