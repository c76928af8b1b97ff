"""The warp-iteration statistics of a chained launch
(``ops/megakernel.py::warp_iterations``, ``chained_segs``): what a loop of
whole samples per thread, a per-lane loop and perfect packing would each
cost in warp-bounces, from the bounces each slot's path ran. The tool
tools/ab_megakernel_torch.py and chip_smoke.py print them for the chained
chunk; here they are held to hand-made answers and, on the twin's chained
launch, to the identities sum_max >= max_sum >= sum_mean."""

import numpy as np
import pytest
import torch

from hijiki_tpu_torch.ops import megakernel as mk
from hijiki_tpu_torch.scene.compile import compile_scene
from hijiki_tpu_torch.scene.obj import load_obj_scene
from torch_port_helpers import MESHBOX_SMALL, frame_inputs


def test_warp_iterations_by_hand():
    # two warps of two lanes, two samples:
    # warp 0: per sample max 2, 8 -> 10; lane sums 9, 3 -> 9; means 1.5 + 4.5 = 6
    # warp 1: per sample max 8, 1 -> 9; lane sums 4, 9 -> 9; means 5.5 + 1 = 6.5
    segs = torch.tensor([[1.0, 2, 3, 8], [8, 1, 1, 1]])
    got = mk.warp_iterations(segs, warp=2)
    assert got == {"sum_max": 9.5, "max_sum": 9.0, "sum_mean": 6.25}


def test_warp_iterations_pads_the_last_warp():
    # 33 lanes: a full warp of 1-bounce paths and a warp holding one
    # 32-bounce path beside 31 padded (empty) lanes
    segs = torch.ones((1, 33))
    segs[0, 32] = 32.0
    got = mk.warp_iterations(segs)
    assert got == {"sum_max": (1 + 32) / 2, "max_sum": (1 + 32) / 2, "sum_mean": (1 + 1) / 2}


@pytest.mark.parametrize("warp", [1, 4, 32])
def test_warp_iterations_equal_when_uniform(warp):
    segs = torch.full((3, 64), 5.0)
    got = mk.warp_iterations(segs, warp=warp)
    assert got == {"sum_max": 15.0, "max_sum": 15.0, "sum_mean": 15.0}


def test_chained_twin_segs_identities():
    """The twin's chained launch at 32x32, S = 3, chain cap 8: every slot's
    segs is its parked or its flushed count (the other is 0), between 1 and
    the cap, and the ratios order as sum_max >= max_sum >= sum_mean."""
    s = load_obj_scene(MESHBOX_SMALL)
    s.put_cbox_spheres()
    ms = mk.mega_scene(compile_scene(s), 32, 32, "cpu")
    px, py, seeds = frame_inputs(32, 32, 0.37, 0.61, 2654435761)
    k = np.arange(3, dtype=np.float32)[:, None]
    pxs = torch.from_numpy(px[None] + 0.25 * k)
    pys = torch.from_numpy(py[None] - 0.125 * k)
    sds = torch.from_numpy((seeds[None] + np.uint32(977) * k.astype(np.uint32)).view(np.int32))
    pool, _, chain_out = mk.megakernel_start_chained_plain(ms, pxs, pys, sds, 8)
    segs = mk.chained_segs(pool, chain_out, 3)
    assert segs.shape == (3, 32 * 32)
    parked = (pool[0] > 0).view(3, -1)
    assert torch.equal(segs[parked], torch.full_like(segs[parked], 8.0))
    assert ((segs >= 1) & (segs <= 8)).all()
    got = mk.warp_iterations(segs)
    assert got["sum_max"] >= got["max_sum"] >= got["sum_mean"] > 0
    assert got["sum_max"] > got["sum_mean"]  # paths differ in length
