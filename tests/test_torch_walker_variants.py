"""The port's one per-thread walk (csrc/walk.cuh, and the plain twin that
the CPU runs) against each walker variant of the TPU megakernel.

``hijiki_tpu``'s ``render_tiles`` walks the trace rows with one of several
walkers, chosen by its knobs: the VMEM walk (the default), the HBM walk
(``table_in_hbm``), the HBM window walk (``hbm_window=2``), the HBM walk
with its VMEM trunk cache (``trunk_rows=64``), the grouped HBM walk
(``groups=2, packet=256``) and the software-pipelined walk with its
pipelined winner resolve (``spec_resolve``). Each computes the same closest
and any hit. Here the port's ``render_tiles`` (the twin, on the CPU) is held
against each, run in interpret mode, on the random scenes of
tests/test_format_matrix.py (classic rows, one table), with that file's
gates: a fetch-source variant may not change a single visited row or
accept, so its final RNG states must equal the port's bit for bit; the
grouped walker rebuilds packets (a t-tie winner may move), so it is held to
the sum of the image within 1e-3 relative.

The grouped walker needs whole tiles of 8 x 256 lanes, twice the 32x32
frame: its call traces the frame and a second, jittered copy of it, and only
the frame is compared.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hijiki_tpu.ops.pallas_megakernel import render_tiles as j_render_tiles
from hijiki_tpu.scene.compile import compile_scene, scene_to_device
from hijiki_tpu_torch.ops import megakernel as mk
from test_fuzz_oracle import random_scene
from torch_port_helpers import frame_inputs, port_scene

W = H = 32
BOUNCES = 8
# (name, render_tiles knobs, bit-exact gate)
VARIANTS = [
    ("hbm", dict(table_in_hbm=True), True),
    ("hbm_window2", dict(table_in_hbm=True, hbm_window=2), True),
    # the trunk cache (the table's first 64 rows served from VMEM): a fetch
    # source, so the port's walk is its check; mega_trunk resolves to 0 in
    # the port, which streams no table
    ("hbm_trunk", dict(table_in_hbm=True, trunk_rows=64), True),
    ("spec_resolve", dict(spec=True, spec_resolve=True), True),
    ("hbm_grouped", dict(table_in_hbm=True, groups=2, packet=256), False),
]


@pytest.fixture(scope="module", params=[77, 123])
def scene(request):
    jcs = compile_scene(random_scene(request.param), octant_tables="never")
    px, py, seeds = frame_inputs(W, H, 0.37, 0.61, 2654435761)
    ms = mk.mega_scene(port_scene(jcs), W, H, "cpu")
    total, _, _, state = mk.render_tiles(ms, torch.from_numpy(px), torch.from_numpy(py),
                                         torch.from_numpy(seeds.view(np.int32)),
                                         max_bounces=BOUNCES)
    return scene_to_device(jcs), (px, py, seeds), total.numpy(), state.numpy().view(np.uint32)


def _jax_film(jcs, px, py, seeds, knobs):
    n = px.shape[0]
    if knobs.get("packet", 128) * 8 > n:  # whole tiles: a jittered copy of the frame after it
        reps = knobs["packet"] * 8 // n
        px = np.concatenate([px] + [px + 0.25 * k for k in range(1, reps)])
        py = np.concatenate([py] + [py - 0.125 * k for k in range(1, reps)])
        seeds = np.concatenate([seeds] + [seeds + np.uint32(977 * k) for k in range(1, reps)])
    knobs = dict(dict(spec=False), **knobs)
    total, _, _, state = j_render_tiles(jcs, jnp.asarray(px), jnp.asarray(py), jnp.asarray(seeds),
                                        width=W, height=H, max_bounces=BOUNCES, interpret=True,
                                        **knobs)
    return np.asarray(total)[:n], np.asarray(state)[:n].astype(np.uint32)


@pytest.mark.parametrize("name,knobs,exact", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_port_walk_matches_walker_variant(scene, name, knobs, exact):
    jcs, (px, py, seeds), total, state = scene
    jtotal, jstate = _jax_film(jcs, px, py, seeds, knobs)
    assert float(total.mean()) > 0.0
    if exact:
        np.testing.assert_array_equal(state, jstate)
    else:
        assert abs(total.sum() - jtotal.sum()) <= 1e-3 * abs(jtotal.sum()) + 1e-6
