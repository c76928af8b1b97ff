"""The port's BSDFs (``ops/bsdf.py``) and next-event estimation
(``ops/emitter.py``) against ``hijiki_tpu``'s on the same shading points:
the hits of numpy-seeded rays, populated by the JAX package, with random
u32 RNG states.

Bounds: RNG states bit-equal on every lane (the draws and their predicated
commits are exact integer arithmetic); directions, weights, extinction,
BSDF values and emitter importance within rtol 1e-4 / atol 1e-5 (XLA's FMA
contraction and its own sin/cos/atan2 differ from torch's in the last
bits; importance divides by a squared distance)."""

import jax.numpy as jnp
import numpy as np
import pytest

from hijiki_tpu.ops import bsdf as JB, emitter as JE
from hijiki_tpu.ops.intersect import intersect_rows, populate_intersection
from hijiki_tpu_torch.ops import bsdf as PB, emitter as PE
from hijiki_tpu_torch.ops.intersect import Its
from hijiki_tpu_torch.ops.rng import as_state
from torch_port_helpers import random_rays, scene_pair, t


def _shading_points(name, n=2048, seed=11):
    jd, pd = scene_pair(name)
    o, d, tmin, tmax = random_rays(jd, n, seed)
    tmax[::7] = np.inf
    jh = intersect_rows(o, d, tmin, tmax, scene=jd)
    jits = populate_intersection(jnp.asarray(o), jnp.asarray(d), jh, jd)
    handle = np.asarray(jd.materials)[np.minimum(np.asarray(jits.shape_id), jd.num_shapes - 1)]
    jtag, jidx = JB.split_handle(jnp.asarray(handle))
    its = Its(*(t(np.asarray(x)) for x in jits))
    tag, idx = PB.split_handle(t(handle.astype(np.int64)))
    state = np.random.default_rng(seed).integers(0, 1 << 32, n, dtype=np.uint32)
    return dict(jd=jd, pd=pd, d=d, jits=jits, its=its, jtag=jtag, jidx=jidx, tag=tag, idx=idx,
                valid=np.asarray(jh.valid), state=state)


@pytest.fixture(scope="module", params=["mixed", "cornell-glass", "many_emitters", "meshbox_small"])
def pts(request):
    return _shading_points(request.param)


def _close(a, b, mask=None):
    a, b = np.asarray(a), np.asarray(b)
    if mask is not None:
        a, b = a[mask], b[mask]
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_split_handle_and_select_row(pts):
    np.testing.assert_array_equal(pts["tag"].numpy(), np.asarray(pts["jtag"]))
    np.testing.assert_array_equal(pts["idx"].numpy(), np.asarray(pts["jidx"]))
    for table in ("diffuse_color", "emissive_power", "sphere_pos_radius"):
        for idx in (pts["idx"], pts["idx"] + 3):  # rows past the table too
            got = PB.select_row(getattr(pts["pd"], table), idx)
            want = JB.select_row(getattr(pts["jd"], table), jnp.asarray(idx.numpy()))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_eval_bsdf_and_base_color(pts):
    wi = np.random.default_rng(3).standard_normal((len(pts["d"]), 3)).astype(np.float32)
    got = PB.eval_bsdf(pts["pd"], pts["tag"], pts["idx"], t(wi), pts["its"])
    want = JB.eval_bsdf(pts["jd"], pts["jtag"], pts["jidx"], jnp.asarray(wi), pts["jits"])
    _close(got.numpy(), want)
    got = PB.base_color(pts["pd"], pts["tag"], pts["idx"], pts["its"])
    want = JB.base_color(pts["jd"], pts["jtag"], pts["jidx"], pts["jits"])
    _close(got.numpy(), want)


def test_sample_bsdf(pts):
    n = len(pts["d"])
    ext = (np.random.default_rng(4).random((n, 3)) * 0.2).astype(np.float32)
    active = pts["valid"]
    got = PB.sample_bsdf(pts["pd"], pts["tag"], pts["idx"], t(pts["d"]), pts["its"],
                         as_state(pts["state"]), t(ext), t(active))
    want = JB.sample_bsdf(pts["jd"], pts["jtag"], pts["jidx"], jnp.asarray(pts["d"]), pts["jits"],
                          jnp.asarray(pts["state"]), jnp.asarray(ext), jnp.asarray(active))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).astype(np.int64))
    for g, w in zip(got[1:], want[1:]):
        _close(g.numpy(), w, active)
    # every material branch ran: diffuse, checkerboard or mirror, dielectric
    tags = set(pts["tag"][t(active)].tolist())
    assert len(tags) >= 3


def test_sample_emitter(pts):
    """Unrolled (<= 8 emitters) or gather path (many_emitters: 10)."""
    active = pts["valid"] & (pts["tag"].numpy() <= 1)
    p = pts["its"].p
    got_state, got = PE.sample_emitter(pts["pd"], as_state(pts["state"]), p, t(active))
    want_state, want = JE.sample_emitter(pts["jd"], jnp.asarray(pts["state"]),
                                         jnp.asarray(p.numpy()), jnp.asarray(active))
    np.testing.assert_array_equal(got_state.numpy(), np.asarray(want_state).astype(np.int64))
    for f in ("importance", "shadow_d", "shadow_tmin", "shadow_tmax"):
        _close(getattr(got, f).numpy(), getattr(want, f), active)
    assert active.sum() > 100
