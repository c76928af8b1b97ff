"""The sync driver's integrator, ``ops/integrate.py::integrate``, against
``hijiki_tpu``'s on the same camera rays and seeds (meshbox_small with the
cbox spheres, 32x32, max_bounces 24), for every traversal: ``rows`` (K6's
twin), ``bvh``, ``brute`` and the port's ``packet`` (against JAX's
``rows``: JAX runs its packet kernel only on a TPU), plus the albedo AOV.

Bound (the bar the port's megakernel twin meets against JAX): on >= 99.5%
of paths the final RNG state is bit-equal and radiance, first-hit normal,
depth and albedo are within 2e-3. The rest are paths that a last-bit
difference rerouted (XLA's FMA contraction, its sin/cos/atan2) at a t-tie
or an edge; here 2 of 1024 paths take another shadow-ray answer with the
same RNG stream, and JAX's own ``rows`` and ``bvh`` differ on the same 2
(XLA fuses, and so contracts, the two walks differently; the port's
traversals agree with each other on every path)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hijiki_tpu.ops.camera import camera_rays as j_camera
from hijiki_tpu.ops.integrate import integrate as j_integrate
from hijiki_tpu.ops.rng import seed_rng as j_seed
from hijiki_tpu_torch.ops.camera import camera_rays
from hijiki_tpu_torch.ops.integrate import integrate, make_intersectors
from hijiki_tpu_torch.ops.rng import as_state, seed_rng
from torch_port_helpers import frame_inputs, scene_pair, t

S = 32
MAX_BOUNCES = 24


@pytest.fixture(scope="module")
def setup():
    jd, pd = scene_pair("meshbox_small")
    px, py, seeds = frame_inputs(S, S, 0.31, 0.77, 2654435761)
    pxy = np.stack([px, py], -1)
    return jd, pd, pxy, seeds, {}


def _jax(setup, traversal, albedo):
    jd, _, pxy, seeds, cache = setup
    key = (traversal, albedo)
    if key not in cache:
        o, d, tmin, tmax = j_camera(jd.cam_position, jd.cam_rotation, jd.cam_fov, jnp.asarray(pxy),
                                    jnp.asarray([S, S], jnp.float32))
        out = j_integrate(jd, o, d, tmin, tmax, j_seed(jnp.asarray(seeds)), max_bounces=MAX_BOUNCES,
                          traversal=traversal, albedo_aov=albedo)
        cache[key] = [np.asarray(x) for x in out]
    return cache[key]


def _port(setup, traversal, albedo, use_bvh=True):
    _, pd, pxy, seeds, _ = setup
    o, d, tmin, tmax = camera_rays(pd.cam_position, pd.cam_rotation, pd.cam_fov, t(pxy), (S, S))
    return integrate(pd, o, d, tmin, tmax, seed_rng(as_state(seeds)), max_bounces=MAX_BOUNCES,
                     traversal=traversal, use_bvh=use_bvh, albedo_aov=albedo)


def _agree(out, ref, albedo=False):
    agree = out.state.numpy() == ref[4].astype(np.int64)
    fields = [(out.total, ref[0]), (out.normal, ref[1]), (out.depth[:, None], ref[2][:, None])]
    if albedo:
        fields.append((out.albedo, ref[3]))
    for got, want in fields:
        agree &= np.isclose(got.numpy(), want, rtol=2e-3, atol=2e-3).all(-1)
    assert agree.mean() >= 0.995, f"paths agree on {agree.mean():.2%}"
    assert out.total.mean() > 0


@pytest.mark.parametrize("traversal,ref", [("rows", "rows"), ("bvh", "bvh"), ("brute", "brute"),
                                           ("packet", "rows")])
def test_integrate_matches_jax(setup, traversal, ref):
    out = _port(setup, traversal, False)
    _agree(out, _jax(setup, ref, False))
    assert 3 < out.iterations <= MAX_BOUNCES


def test_albedo_aov_matches_jax(setup):
    out = _port(setup, "rows", True)
    _agree(out, _jax(setup, "rows", True), albedo=True)
    assert out.albedo.abs().sum() > 0
    assert torch.equal(out.total, _port(setup, "rows", False).total)  # the AOV changes no radiance


def test_packet_and_rows_bit_equal_and_use_bvh(setup):
    """The two trace-row walks give the same paths bit for bit; use_bvh
    False forces brute force whatever the traversal."""
    a, b = _port(setup, "rows", False), _port(setup, "packet", False)
    for x, y in zip(a[:5], b[:5]):
        assert torch.equal(x, y)
    c, e = _port(setup, "rows", False, use_bvh=False), _port(setup, "brute", False)
    assert torch.equal(c.state, e.state) and torch.equal(c.total, e.total)
    with pytest.raises(ValueError, match="unknown traversal"):
        make_intersectors(setup[1], "octree")
