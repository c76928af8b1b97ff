"""The shadow-ray occlusion cache (``shadow_cache=True``) of the
megakernel's plain twin against hijiki_tpu's, run in interpret mode.

The cache only ever verifies a prediction with the walk's own accept, so
JAX's cache-on render equals its cache-off one bit for bit
(tests/test_megakernel.py::test_shadow_cache_bitwise_identical), and the
port's cache-on twin is held to JAX's cache-on render with the bounds of
tests/test_torch_megakernel.py: on meshbox_small + spheres the final RNG
state bit-equal on >= 99.5% of paths and radiance within rtol/atol 2e-3 on
those (the t-tie reroute class, docs/PARITY.md); on the random scenes of
tests/test_format_matrix.py (one table of classic rows, where the port's
walk takes JAX's accepts, tests/test_torch_walker_variants.py) every final
RNG state bit-equal. The row counters are not compared: JAX counts packet
unions and carries a lane's prediction across its respawns. The skip-all
probe and the options' errors: tests/test_torch_skip_all.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hijiki_tpu.ops import pallas_megakernel as jmk
from hijiki_tpu.scene.compile import compile_scene as j_compile, scene_to_device
from hijiki_tpu.scene.obj import load_obj_scene as j_load
from hijiki_tpu_torch.ops import megakernel as mk
from test_fuzz_oracle import random_scene
from test_torch_megakernel import assert_paths_agree
from torch_port_helpers import MESHBOX_SMALL, frame_inputs, port_scene

W = H = 32
BOUNCES = 12
RANDOM_SEEDS = {"random77": 77, "random123": 123}


def _jax_scene(name):
    if name == "meshbox_small":
        s = j_load(MESHBOX_SMALL)
        s.put_cbox_spheres()
        return j_compile(s)
    return j_compile(random_scene(RANDOM_SEEDS[name]), octant_tables="never")


def _inputs():
    px, py, seeds = frame_inputs(W, H, 0.37, 0.61, 2654435761)
    return (px, py, seeds), (torch.from_numpy(px), torch.from_numpy(py),
                             torch.from_numpy(seeds.view(np.int32)))


def _agree(name, jrng, rng, jtotal, total):
    if name == "meshbox_small":
        assert_paths_agree(jrng, rng, jtotal, total)
    else:
        np.testing.assert_array_equal(np.asarray(jrng).astype(np.uint32),
                                      rng.numpy().view(np.uint32))


@pytest.mark.parametrize("name", ["meshbox_small", "random77", "random123"])
def test_render_tiles_cache_matches_jax(name):
    jcs = _jax_scene(name)
    ms = mk.mega_scene(port_scene(jcs), W, H, "cpu")
    (px, py, seeds), targs = _inputs()
    jt = jmk.render_tiles(scene_to_device(jcs), jnp.asarray(px), jnp.asarray(py),
                          jnp.asarray(seeds), width=W, height=H, max_bounces=BOUNCES,
                          interpret=True, shadow_cache=True)
    total, _, _, state = mk.render_tiles(ms, *targs, max_bounces=BOUNCES, shadow_cache=True)
    _agree(name, jt[3], state, jt[0], total)
    assert float(total.mean()) > 0.0


def test_render_waves_cache_matches_jax():
    jcs = _jax_scene("meshbox_small")
    ms = mk.mega_scene(port_scene(jcs), W, H, "cpu")
    (px, py, seeds), targs = _inputs()
    jw = jmk.render_waves(scene_to_device(jcs), jnp.asarray(px), jnp.asarray(py),
                          jnp.asarray(seeds), width=W, height=H, max_bounces=BOUNCES,
                          phase_bounces=(5, 8), interpret=True, shadow_cache=True)
    tw = mk.render_waves(ms, *targs, max_bounces=BOUNCES, phase_bounces=(5, 8),
                         shadow_cache=True)
    assert int(jw[4]) == 0 and int(tw[4]) == 0
    assert_paths_agree(jw[3], tw[3], jw[0], tw[0])
