"""The regenerating wavefront driver, ``render/wavefront.py``, against
``hijiki_tpu``'s ``render_wavefront`` (pools of 256 and 1024 lanes, and 512
sorted lanes) and against the port's own sync driver, on meshbox_small
with the cbox spheres at 32x32, max_bounces 24.

Bounds: against JAX, the integrator's bar (test_torch_integrate.py): >=
99.5% of items within 2e-3 in color, normal and depth. Against the port's
sync driver: JAX's own wavefront-vs-sync bound (tests/test_wavefront.py,
rtol 1e-4 / atol 2e-4); each item runs the same per-lane operations on the
same RNG stream in both drivers, and the port's two are in fact bit-equal,
which is asserted too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hijiki_tpu.render.wavefront import render_wavefront as j_wavefront
from hijiki_tpu_torch.ops.camera import camera_rays
from hijiki_tpu_torch.ops.integrate import integrate
from hijiki_tpu_torch.ops.rng import as_state, seed_rng
from hijiki_tpu_torch.render.wavefront import render_wavefront
from torch_port_helpers import frame_inputs, scene_pair, t

S = 32
MB = 24


@pytest.fixture(scope="module")
def setup():
    jd, pd = scene_pair("meshbox_small")
    px, py, seeds = frame_inputs(S, S, 0.43, 0.19, 2246822519)
    return jd, pd, np.stack([px, py], -1), seeds


def _port(setup, lanes, sort=False, max_iters=None):
    _, pd, pxy, seeds = setup
    mi = max_iters or MB * max(1, S * S // lanes) + 64
    return render_wavefront(pd, t(pxy), as_state(seeds), (S, S), num_lanes=lanes, max_iters=mi,
                            max_path_bounces=MB, sort_lanes=sort)


def _jax(setup, lanes, sort=False, max_iters=None):
    jd, _, pxy, seeds = setup
    mi = max_iters or MB * max(1, S * S // lanes) + 64
    out = j_wavefront(jd, jnp.asarray(pxy), jnp.asarray(seeds), jnp.asarray([S, S], jnp.float32),
                      num_lanes=lanes, max_iters=mi, max_path_bounces=MB, sort_lanes=sort)
    return [np.asarray(x) for x in out]


def _sync(setup):
    _, pd, pxy, seeds = setup
    o, d, tmin, tmax = camera_rays(pd.cam_position, pd.cam_rotation, pd.cam_fov, t(pxy), (S, S))
    return integrate(pd, o, d, tmin, tmax, seed_rng(as_state(seeds)), max_bounces=MB)


def _agree_jax(img, ref):
    agree = np.ones(S * S, bool)
    for got, want in zip((img.color, img.normal, img.depth[:, None]), (ref[0], ref[1], ref[2][:, None])):
        agree &= np.isclose(got.numpy(), want, rtol=2e-3, atol=2e-3).all(-1)
    assert agree.mean() >= 0.995, f"items agree on {agree.mean():.2%}"


@pytest.mark.parametrize("lanes,sort", [(256, False), (1024, False), (512, True)])
def test_wavefront_matches_jax_and_sync(setup, lanes, sort):
    img = _port(setup, lanes, sort)
    _agree_jax(img, _jax(setup, lanes, sort))
    sync = _sync(setup)
    np.testing.assert_allclose(img.color.numpy(), sync.total.numpy(), rtol=1e-4, atol=2e-4)
    assert torch.equal(img.color, sync.total) and torch.equal(img.normal, sync.normal)
    assert torch.equal(img.depth, sync.depth)
    # the pool needs at least the longest path's bounces
    assert sync.iterations <= img.iterations < MB * max(1, S * S // lanes) + 64


def test_pool_larger_than_queue(setup):
    """4096 lanes for 1024 items: the idle lanes' flushes land in the trash
    row (JAX's out-of-bounds-drop scatter) and leave the film untouched."""
    img = _port(setup, 4 * S * S)
    sync = _sync(setup)
    assert torch.equal(img.color, sync.total) and torch.equal(img.depth, sync.depth)


def test_max_iters_cut_matches_jax(setup):
    """A pool cut short by max_iters leaves the same paths unfinished as in
    JAX: the termination rule carries over exactly."""
    img = _port(setup, 256, max_iters=9)
    ref = _jax(setup, 256, max_iters=9)
    assert img.iterations == 9
    np.testing.assert_array_equal(img.color.numpy() == 0, ref[0] == 0)
    _agree_jax(img, ref)
    assert not torch.equal(img.color, _sync(setup).total)
