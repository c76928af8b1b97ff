"""The megakernel's plain twin on every trace-row format, with the
shadow-visibility boxes and with the dedicated shadow table, against
hijiki_tpu's render_tiles in interpret mode, and against itself where the
port must be exact. (The CUDA kernels are held against the twin on the
card in tests/test_torch_cuda.py.)

Bounds against the TPU kernel, as tests/test_torch_megakernel.py states
them: the final RNG state bit-equal on >= 99.5% of paths, and >= 99.5% of
paths agreeing on both the RNG and the radiance within rtol/atol 2e-3 (the
silhouette/t-tie reroute class, docs/PARITY.md); the first-hit depth to f32
rounding on >= 99% of hitting paths. Within the port: a packed table
against the classic one of the same tree (leaf 4), the boxes and the shadow
table against neither, are bit-equal in every output but the rows counter,
which the boxes and the shadow table lower."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hijiki_tpu.ops import pallas_megakernel as jmk
from hijiki_tpu.scene.compile import compile_scene as j_compile, scene_to_device
from hijiki_tpu.scene.obj import load_obj_scene as j_load
from hijiki_tpu_torch.ops import megakernel as mk
from hijiki_tpu_torch.scene.compile import compile_scene
from hijiki_tpu_torch.scene.obj import load_obj_scene
from test_torch_megakernel import assert_paths_agree
from torch_port_helpers import MESHBOX_SMALL, frame_inputs, port_scene

W = H = 32
BOUNCES = 12
# (packed_leaf, shadow-visibility boxes, dedicated shadow table)
CONFIGS = {
    "classic": (0, True, False), "noboxes": (0, False, False), "slim": (1, True, False),
    "packed3": (3, True, False), "packed4": (4, True, False), "packed12": (12, True, False),
    "shadow_tbl": (0, True, True),
}


def _jax(packed, boxes):
    s = j_load(MESHBOX_SMALL)
    s.put_cbox_spheres()
    return j_compile(s, packed_leaf=packed, shadow_vis_boxes=boxes)


def _inputs():
    px, py, seeds = frame_inputs(W, H, 0.37, 0.61, 2654435761)
    return px, py, seeds, (torch.from_numpy(px), torch.from_numpy(py),
                           torch.from_numpy(seeds.view(np.int32)))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_render_tiles_matches_tpu_kernel_per_format(config):
    packed, boxes, tbl = CONFIGS[config]
    jcs = _jax(packed, boxes)
    ms = mk.mega_scene(port_scene(jcs), W, H, "cpu")
    assert ms.packed == jcs.mega_packed_static and ms.nbox == (16 if boxes else 0)
    px, py, seeds, targs = _inputs()
    jt = jmk.render_tiles(scene_to_device(jcs), jnp.asarray(px), jnp.asarray(py),
                          jnp.asarray(seeds), width=W, height=H, max_bounces=BOUNCES,
                          interpret=True, shadow_tbl=tbl)
    total, _, depth, state = mk.render_tiles(ms, *targs, max_bounces=BOUNCES,
                                   shadow_tbl=tbl)
    assert_paths_agree(jt[3], state, jt[0], total)
    hit = np.asarray(jt[2]) > 0
    rel = np.abs(depth.numpy() - np.asarray(jt[2]))[hit] / np.asarray(jt[2])[hit]
    assert (rel < 1e-5).mean() >= 0.99
    assert float(total.mean()) > 0.01


def _port(packed=0, boxes=True, leaf_size=1):
    s = load_obj_scene(MESHBOX_SMALL)
    s.put_cbox_spheres()
    return mk.mega_scene(compile_scene(s, packed_leaf=packed, shadow_vis_boxes=boxes,
                                       leaf_size=leaf_size), W, H, "cpu")


def test_packed4_equals_classic_at_leaf_4():
    """PACKED4 and the classic rows of the same leaf-4 tree (the JAX
    suite's test_megakernel.py:590): every state channel but rows, and the
    RNG, bit for bit."""
    _, _, _, targs = _inputs()
    p4 = mk.megakernel_start(_port(4), *targs, BOUNCES)
    c4 = mk.megakernel_start(_port(0, leaf_size=4), *targs, BOUNCES)
    rows = mk._STATE_CH.index("rows")
    keep = [i for i in range(mk.N_STATE) if i != rows]
    assert torch.equal(p4[1], c4[1])
    assert torch.equal(p4[0][keep].view(torch.int32), c4[0][keep].view(torch.int32))
    assert float(p4[0][rows].sum()) < float(c4[0][rows].sum())


@pytest.mark.parametrize("packed", [0, 1, 3, 4, 12])
def test_boxes_and_shadow_table_change_only_rows(packed):
    """The boxes (and, on classic rows, the dedicated shadow table) skip or
    reroute shadow walks only: the film, RNG and hit records of render_waves
    are bit-equal with and without them, and fewer rows are visited."""
    _, _, _, targs = _inputs()
    ms = _port(packed)
    off = mk.render_waves(ms, *targs, max_bounces=BOUNCES, shadow_vis=False)
    runs = [mk.render_waves(ms, *targs, max_bounces=BOUNCES)]
    if packed == 0:
        runs.append(mk.render_waves(ms, *targs, max_bounces=BOUNCES, shadow_tbl=True))
    for on in runs:
        for i in (0, 1, 2, 3, 5, 7):  # total, normal, depth, RNG, segs, albedo
            assert torch.equal(on[i].view(torch.int32), off[i].view(torch.int32)), i
        assert float(on[6].sum()) < float(off[6].sum())


def test_shadow_table_needs_one():
    """shadow_tbl on a scene compiled without a dedicated table raises (JAX's
    _check_shadow_tbl)."""
    _, _, _, targs = _inputs()
    with pytest.raises(ValueError, match="dedicated shadow table"):
        mk.render_tiles(_port(4), *targs, max_bounces=2, shadow_tbl=True)
