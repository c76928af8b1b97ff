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


@pytest.mark.parametrize("group", [1, 32])
@pytest.mark.parametrize("table", ["w32", "w16", "slim", "pack3", "pack4", "pack12"])
def test_walk_isolate_row_kinds_sum_to_rows(table, group):
    """K10b's plain walk splits its rows as the megakernels' does: interior
    rows and the table's prim rows (format 0 for the classic rows and
    their 16-column copy) sum to its rows visited, and a packed table has
    prim rows of its own format only. chip_smoke.py charges K10b's rows at
    this split."""
    from hijiki_tpu_torch.probes import walk_probe as W

    ms, cs = W.load_scene(MESHBOX_SMALL, "cpu", 16, 16, W.TABLES[table])
    rows = W.w16_rows(ms.rows).contiguous() if table == "w16" else ms.rows
    o, d = W.ray_set("camera", cs, 256, "cpu", frame=16)
    mk.reset_row_kinds()
    _, nit = W.walk_isolate_plain(ms, rows, o, d, group=group)
    kinds = mk.row_kinds()
    assert set(kinds) == {"interior", ms.packed}
    assert sum(kinds.values()) == int(nit.sum()) and kinds[ms.packed] > 0
