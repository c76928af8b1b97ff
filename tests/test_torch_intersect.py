"""The port's ``ops/intersect.py`` against ``hijiki_tpu/ops/intersect.py`` on
the same numpy-seeded rays and compiled scenes: the unified primitive
test, brute force (in several chunks), the lockstep BVH walk at leaf sizes
1 and 2 (closest and any hit), and ``populate_intersection``.

Bounds: hit flags, slots and shape ids equal on every ray; t within rtol
1e-5 / atol 1e-6 and u, v within 1e-5 (XLA's FMA contraction, see
test_torch_traverse.py); the shading frame and point within rtol 1e-5 /
atol 1e-5 and the sphere UVs within 1e-6 (torch's and XLA's atan2/asin
differ in the last bits)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hijiki_tpu.ops import intersect as J
from hijiki_tpu_torch.ops import intersect as P
from torch_port_helpers import random_rays, scene_pair, t


def _hits_equal(h, jh):
    np.testing.assert_array_equal(h.valid.numpy(), np.asarray(jh.valid))
    np.testing.assert_array_equal(h.prim_slot.numpy(), np.asarray(jh.prim_slot))
    np.testing.assert_array_equal(h.shape_id.numpy(), np.asarray(jh.shape_id))
    np.testing.assert_allclose(h.t.numpy(), np.asarray(jh.t), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(h.u.numpy(), np.asarray(jh.u), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.v.numpy(), np.asarray(jh.v), rtol=1e-5, atol=1e-5)


def test_unified_test_matches():
    """Every (ray, prim) pair of the mixed scene (spheres, quads,
    triangles), broadcast as the brute-force path broadcasts it."""
    jd, pd = scene_pair("mixed")
    o, d, tmin, tmax = random_rays(jd, 512, seed=1)
    P_ = pd.num_prims
    args = (o[:, None], d[:, None], tmin[:, None], tmax[:, None])
    prims = [np.asarray(getattr(jd, f))[:P_] for f in ("prim_a", "prim_b", "prim_c", "prim_kind")]
    jh, jt, ju, jv = (np.asarray(x) for x in J.intersect_unified(*args, *prims))
    h, pt_, pu, pv = (x.numpy() for x in P.intersect_unified(*map(t, args), *map(t, prims)))
    np.testing.assert_array_equal(h, jh)
    both = np.isfinite(jt) & jh
    np.testing.assert_allclose(pt_[both], jt[both], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pu[both], ju[both], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pv[both], jv[both], rtol=1e-5, atol=1e-5)
    assert jh.any()


def test_brute_force_in_chunks_matches(monkeypatch):
    """A chunk of 3 rays x all prims: 334 chunks for 1000 rays."""
    jd, pd = scene_pair("meshbox_small")
    o, d, tmin, tmax = (x[:1000] for x in random_rays(jd, 1000, seed=2))
    monkeypatch.setattr(P, "BRUTE_CHUNK", 3 * pd.num_prims)
    h = P.intersect_brute(t(o), t(d), t(tmin), t(tmax), scene=pd)
    _hits_equal(h, J.intersect_brute(o, d, tmin, tmax, scene=jd))
    occ = P.occluded_brute(t(o), t(d), t(tmin), t(tmax), scene=pd)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(h.valid))


@pytest.mark.parametrize("leaf_size", [1, 2])
def test_bvh_walk_matches(leaf_size):
    """The compiled BVH's leaves hold up to ``leaf_size`` prims; the walk
    tests that many per leaf."""
    jd, pd = scene_pair("meshbox_small", leaf_size=leaf_size)
    o, d, tmin, tmax = random_rays(jd, 1024, seed=3 + leaf_size)
    active = np.arange(1024) % 5 != 2
    h = P.intersect_bvh(t(o), t(d), t(tmin), t(tmax), t(active), scene=pd, leaf_size=leaf_size)
    _hits_equal(h, J.intersect_bvh(o, d, tmin, tmax, active, scene=jd, leaf_size=leaf_size))
    occ = P.occluded_bvh(t(o), t(d), t(tmin), t(tmax), t(active), scene=pd, leaf_size=leaf_size)
    want = J.occluded_bvh(o, d, tmin, tmax, active, scene=jd, leaf_size=leaf_size)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want))
    # the BVH walk and the trace-row walk find the same hits
    r = P.intersect_rows(t(o), t(d), t(tmin), t(tmax), t(active), scene=pd)
    assert torch.equal(r.prim_slot, h.prim_slot) and torch.equal(r.valid, h.valid)


@pytest.mark.parametrize("name", ["meshbox_small", "mixed"])
def test_populate_intersection_matches(name):
    """Both packages shade the same Hit (the JAX walk's): point, shading
    normal and frame, UVs."""
    jd, pd = scene_pair(name)
    o, d, tmin, tmax = random_rays(jd, 2048, seed=7)
    jh = J.intersect_rows(o, d, tmin, tmax, scene=jd)
    keep = np.asarray(jh.valid)
    hit = P.Hit(*(t(np.asarray(x)) for x in jh[:6]))
    its = P.populate_intersection(t(o), t(d), hit, pd)
    jits = J.populate_intersection(jnp.asarray(o), jnp.asarray(d), jh, jd)
    for f in ("p", "n", "frame_t", "frame_b"):
        np.testing.assert_allclose(getattr(its, f).numpy()[keep], np.asarray(getattr(jits, f))[keep],
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    np.testing.assert_allclose(its.uv.numpy()[keep], np.asarray(jits.uv)[keep], rtol=1e-5, atol=1e-5)
    assert keep.mean() > 0.3
