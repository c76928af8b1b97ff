"""The twin's split of the rows it visits (``mk.row_kinds``): interior rows,
each walked table format's prim rows and the closest hits' winner rows read
to shade sum to the ``rows`` counter, on
every trace-row format, with the dedicated shadow table and with the
occlusion cache. chip_smoke.py charges a kernel's rows at the ops of its
plain version's split (an interior row 26, a prim row its format's,
a winner's row read none)."""

import numpy as np
import pytest
import torch

from hijiki_tpu_torch.ops import megakernel as mk
from hijiki_tpu_torch.scene.compile import compile_scene
from hijiki_tpu_torch.scene.obj import load_obj_scene
from torch_port_helpers import MESHBOX_SMALL, frame_inputs

W = H = 16
BOUNCES = 8
ROWS = mk._STATE_CH.index("rows")
# (packed_leaf, launch options, the formats whose prim rows the walks visit)
CONFIGS = {"classic": (0, {}, {0}), "shadow_tbl": (0, dict(shadow_tbl=True), {0, 3}),
           "cache": (0, dict(shadow_cache=True), {0}), "slim": (1, {}, {1}),
           "packed3": (3, {}, {3}), "packed4": (4, {}, {4}), "packed12": (12, {}, {12})}


def _inputs():
    px, py, seeds = frame_inputs(W, H, 0.37, 0.61, 2654435761)
    return torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(seeds.view(np.int32))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_row_kinds_sum_to_rows(config):
    packed, opts, formats = CONFIGS[config]
    s = load_obj_scene(MESHBOX_SMALL)
    s.put_cbox_spheres()
    ms = mk.launch_scene(mk.mega_scene(compile_scene(s, packed_leaf=packed), W, H, "cpu"), **opts)
    px, py, seeds = _inputs()
    mk.reset_row_kinds()
    st, rng = mk.megakernel_start(ms, px, py, seeds, 3)
    kinds = mk.row_kinds()
    assert sum(kinds.values()) == int(st[ROWS].sum())
    assert {k for k, v in kinds.items() if v and k not in ("interior", "resolve")} == formats
    assert kinds["interior"] > 0 and kinds["resolve"] > 0
    # a resume counts the rows it adds to the state's counter
    mk.reset_row_kinds()
    out, _ = mk.megakernel_resume(ms, st, rng, BOUNCES)
    assert sum(mk.row_kinds().values()) == int((out[ROWS] - st[ROWS]).sum())
