"""The occlusion cache's pretest of the port's twin (``_row_occludes``)
against hijiki_tpu's ``_anyhit_pretest`` (pallas_megakernel.py:1700), run
in interpret mode, on every trace-row format of meshbox_small + spheres:
the same shadow rays and predicted rows give the same verified lanes and
the same verifying rows. JAX's render with the cache equals its render
without it bit for bit, so only this comparison holds the port's accept of
a predicted row to JAX's own.

The rays: origins in the scene box, each aimed at another point of it. A
packet of 128 lanes (one sublane) tests up to 4 distinct rows in JAX, so
each sublane predicts from 4 rows: its first half the rows where the
port's any-hit walk accepted those lanes' rays (they should verify), then
rays of other lanes given one of the 4 rows (most fail), lanes with no
prediction (-1) and with a row past the table (untested); one sublane's
rows include the root, an interior row."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from hijiki_tpu.ops import pallas_megakernel as jmk
from hijiki_tpu.scene.compile import compile_scene as j_compile
from hijiki_tpu.scene.obj import load_obj_scene as j_load
from hijiki_tpu_torch.ops import megakernel as mk
from torch_port_helpers import MESHBOX_SMALL, port_scene

SUB, LANES = 8, 128
FORMATS = {"classic": 0, "slim": 1, "packed3": 3, "packed4": 4, "packed12": 12}
EPS = mk._f(mk.M_EPS)


def _jax_scene(packed):
    s = j_load(MESHBOX_SMALL)
    s.put_cbox_spheres()
    return j_compile(s, packed_leaf=packed)


def _rays(jcs, n, seed):
    """(o, d, tmin, tmax) of n shadow-like rays between points of the scene
    box, as (3, n) / (n,) f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    lo, hi = (np.asarray(jcs.bbox_static[i:i + 3], np.float32) for i in (0, 3))
    a = (lo + (hi - lo) * rng.uniform(0.02, 0.98, (n, 3))).astype(np.float32)
    b = (lo + (hi - lo) * rng.uniform(0.02, 0.98, (n, 3))).astype(np.float32)
    v = b - a
    dist = np.sqrt((v * v).sum(1)).astype(np.float32)
    d = (v / dist[:, None]).astype(np.float32)
    return (a.T.copy(), d.T.copy(), np.full(n, 2 * EPS, np.float32),
            (dist - EPS).astype(np.float32))


def _accept_rows(ms, o, d, tmin, tmax):
    """The row where the port's any-hit walk accepted each ray (-1: none,
    or an analytic prim occluded)."""
    T = lambda a: torch.from_numpy(a)
    pred = torch.full((o.shape[1],), -1, dtype=torch.int64)
    _, _, row = mk._trace_any(ms, tuple(T(o)), tuple(T(d)), T(tmin), T(tmax), pred)
    return row.numpy()


def _layout(ms, pool, accept, seed):
    """Lanes (SUB, LANES) of ray indices into ``pool`` and their predicted
    rows, each sublane predicting from 4 rows."""
    rng = np.random.default_rng(seed)
    rows, counts = np.unique(accept[accept >= 0], return_counts=True)
    top = rows[np.argsort(-counts, kind="stable")][: 4 * SUB]
    assert top.size == 4 * SUB, "too few occluding rows among the rays"
    idx = np.zeros((SUB, LANES), np.int64)
    pred = np.full((SUB, LANES), -1, np.int64)
    for k in range(SUB):
        cand = top[4 * k: 4 * k + 4].copy()
        if k == SUB - 1:
            cand[3] = 0  # the root: an interior row
        own = np.flatnonzero(np.isin(accept, cand))
        idx[k, :64] = own[np.arange(64) % own.size]
        pred[k, :64] = accept[idx[k, :64]]
        idx[k, 64:] = rng.integers(0, accept.size, LANES - 64)
        pred[k, 64:96] = rng.choice(cand, 32)
        pred[k, 112:] = ms.total_rows + 3
    return idx, pred


def _jax_pretest(jcs, pred, o, d, tmin, tmax):
    """hijiki_tpu's _anyhit_pretest over one (SUB, LANES) packet tile, in
    interpret mode: (verified flags, verifying rows)."""
    rows = jnp.asarray(np.asarray(jcs.trace_rows_mega, np.float32))
    total = rows.shape[0]
    analytic = jcs.analytic_bake_static if jcs.mega_analytic_mode_static else None
    packed = ((jcs.mega_num_tables_static * jcs.mega_tbl_rows, jcs.mega_pay_rows_static,
               jcs.mega_packed_static) if jcs.mega_packed_static else None)

    def kern(rows_ref, pred_ref, o_ref, d_ref, tmin_ref, tmax_ref, hit_ref, vrow_ref):
        hit, vrow = jmk._anyhit_pretest(
            rows_ref, total, analytic, pred_ref[...], o_ref[0], o_ref[1], o_ref[2],
            d_ref[0], d_ref[1], d_ref[2], tmin_ref[...], tmax_ref[...], packed=packed)
        hit_ref[...] = hit
        vrow_ref[...] = vrow

    out = pl.pallas_call(
        kern, interpret=True,
        out_shape=(jax.ShapeDtypeStruct((SUB, LANES), jnp.float32),
                   jax.ShapeDtypeStruct((SUB, LANES), jnp.int32)),
    )(rows, jnp.asarray(pred, jnp.int32), jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
      jnp.asarray(tmax))
    return np.asarray(out[0]) > 0, np.asarray(out[1])


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_row_occludes_matches_jax_pretest(fmt):
    jcs = _jax_scene(FORMATS[fmt])
    ms = mk.mega_scene(port_scene(jcs), 32, 32, "cpu")
    assert ms.packed == (jcs.mega_packed_static or 0)
    o, d, tmin, tmax = _rays(jcs, 8192, seed=FORMATS[fmt] + 5)
    idx, pred = _layout(ms, o, _accept_rows(ms, o, d, tmin, tmax), seed=FORMATS[fmt])
    o, d = o[:, idx], d[:, idx]  # (3, SUB, LANES)
    tmin, tmax = tmin[idx], tmax[idx]
    j_hit, j_row = _jax_pretest(jcs, pred, o, d, tmin, tmax)

    T = lambda a: torch.from_numpy(np.ascontiguousarray(a).ravel())
    p = torch.from_numpy(pred.ravel())
    tried = (p >= 0) & (p < ms.total_rows)
    verified = tried & mk._row_occludes(ms, p, tuple(T(x) for x in o), tuple(T(x) for x in d),
                                        T(tmin), T(tmax))
    row = torch.where(verified, p, -1)
    np.testing.assert_array_equal(verified.numpy().reshape(SUB, LANES), j_hit)
    np.testing.assert_array_equal(row.numpy().reshape(SUB, LANES), j_row)
    n_ver, n_fail = int(verified.sum()), int((tried & ~verified).sum())
    assert n_ver >= SUB * 64 * 0.9, f"only {n_ver} of the walk's own rows verified"
    assert n_fail > 0, "every tested prediction verified: the test tells nothing apart"
