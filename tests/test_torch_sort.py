"""K7/K8's plain version (hijiki_tpu_torch.ops.sort) against the TPU kernel's
network, hijiki_tpu/ops/pallas_sort.py::sort_tile_by_key, run in interpret
mode as tests/test_megakernel.py runs it; and the lane-sort key of the
sorted megakernels against hijiki_tpu's ``_lane_sort``.

Bounds: bit-equal. The sorted keys, and every payload channel (int32, f32
and u32 as their bits), ties included: the port's network is the TPU's with
its pair-consistent keep rule, so equal keys land in the same lanes. (The
CUDA kernel ``sort_tiles`` is held against this plain version on the card
in tests/test_torch_cuda.py.)"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from hijiki_tpu.ops import pallas_megakernel as jmk
from hijiki_tpu.ops.pallas_sort import PACKET, SUBLANES, sort_tile_by_key
from hijiki_tpu.scene.compile import compile_scene as j_compile
from hijiki_tpu.scene.obj import load_obj_scene as j_load
from hijiki_tpu_torch.ops import megakernel as mk
from hijiki_tpu_torch.ops import sort as srt
from torch_port_helpers import MESHBOX_SMALL, port_scene

N = SUBLANES * PACKET
TILES = 3
DEAD = 1 << 20


def _keys(kind, rng):
    if kind == "random":
        return rng.integers(0, 5000, N)
    if kind == "ties_dead":  # _lane_sort's shape: few distinct keys, dead lanes last
        k = rng.integers(0, 8, N)
        k[rng.random(N) < 0.3] = DEAD
        return k
    if kind == "all_equal":
        return np.full(N, 7)
    if kind == "sorted":
        return np.sort(rng.integers(0, 5000, N))
    if kind == "all_dead":  # a tile whose paths have all finished
        return np.full(N, DEAD)
    if kind == "signed":  # the int32 extremes and negative keys
        k = rng.integers(-5000, 5000, N)
        k[::61] = np.iinfo(np.int32).min
        k[1::67] = np.iinfo(np.int32).max
        return k
    return np.sort(rng.integers(0, 5000, N))[::-1]  # reversed


@jax.jit
def _tpu_sort(key, p, f, u):
    """sort_tile_by_key on one (8,128) tile with an int32, an f32 and a u32
    channel."""

    def kernel(k_ref, p_ref, f_ref, u_ref, ko_ref, po_ref, fo_ref, uo_ref):
        k, (a, b, c) = sort_tile_by_key(k_ref[...], [p_ref[...], f_ref[...], u_ref[...]])
        ko_ref[...] = k
        po_ref[...] = a
        fo_ref[...] = b
        uo_ref[...] = c

    shape = (SUBLANES, PACKET)
    return pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct(shape, dt) for dt in (jnp.int32, jnp.int32, jnp.float32,
                                                             jnp.uint32)],
        interpret=True,
    )(key, p, f, u)


@pytest.mark.parametrize("kind", ["random", "ties_dead", "all_equal", "sorted", "reversed",
                                  "all_dead", "signed"])
def test_sort_tiles_plain_equals_tpu_network(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    key = np.stack([_keys(kind, rng) for _ in range(TILES)]).astype(np.int32)
    ids = np.arange(TILES * N, dtype=np.int32).reshape(TILES, N)
    f = rng.standard_normal((TILES, N)).astype(np.float32)
    f[:, ::97] = np.nan
    f[:, 1::89] = -0.0
    u = rng.integers(0, 1 << 32, (TILES, N), dtype=np.uint64).astype(np.uint32)
    chans = torch.from_numpy(np.stack([ids, f.view(np.int32), u.view(np.int32)]))
    before = dict(srt.LAUNCHES)
    skey, out = srt.sort_tiles(torch.from_numpy(key), chans)
    assert srt.LAUNCHES == before  # a CPU tensor runs the plain version
    for t in range(TILES):
        tile = lambda a: jnp.asarray(a[t].reshape(SUBLANES, PACKET))
        ko, po, fo, uo = (np.asarray(x).ravel() for x in _tpu_sort(tile(key), tile(ids), tile(f),
                                                                   tile(u)))
        np.testing.assert_array_equal(skey[t].numpy(), ko)
        np.testing.assert_array_equal(out[0, t].numpy(), po)
        np.testing.assert_array_equal(out[1, t].numpy(), fo.view(np.int32))
        np.testing.assert_array_equal(out[2, t].numpy(), uo.view(np.int32))
        # a true permutation of the tile that sorts it
        assert (np.diff(ko) >= 0).all()
        np.testing.assert_array_equal(np.sort(po), ids[t])


@pytest.mark.parametrize("lanes", [32, mk.SORT_TILE, srt.TILE])
def test_bitonic_order_sorts_any_power_of_two(lanes):
    """The same network at any power-of-two tile of at least a warp: the
    megakernel's 256-lane tiles, the smallest tile sort.cuh takes (32) and
    K8's 1024."""
    rng = np.random.default_rng(lanes)
    key = torch.from_numpy(rng.integers(0, 9, (5, lanes)).astype(np.int32))
    skey, src = srt.bitonic_order(key)
    assert torch.equal(skey, torch.sort(key, dim=1).values)
    assert torch.equal(torch.gather(key, 1, src), skey)
    assert torch.equal(torch.sort(src, dim=1).values, torch.arange(lanes).expand(5, -1))


def test_lane_sort_key_matches_tpu(monkeypatch):
    """mk.lane_sort_key against the key _lane_sort builds, on states with
    origins inside and outside the scene box, on its bounds, NaN, +-inf and
    +-1e30 (XLA's saturating cast), directions with zero and -0.0
    components, and dead lanes."""
    jcs = j_compile(_meshbox(), shadow_vis_boxes=False)
    ms = mk.mega_scene(port_scene(jcs), 8, 8, "cpu")
    lo, hi = np.asarray(jcs.bbox_static[:3]), np.asarray(jcs.bbox_static[3:])
    rng = np.random.default_rng(11)
    o = (lo - 0.5 * (hi - lo) + 2.0 * (hi - lo) * rng.random((N, 3))).astype(np.float32)
    special = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30, 0.0], np.float32)
    for a in range(3):
        o[a::7, a] = special[rng.integers(0, len(special), len(o[a::7]))]
        o[3 + a::11, a] = lo[a]
        o[5 + a::13, a] = hi[a]
    d = rng.standard_normal((N, 3)).astype(np.float32)
    d[::5, 0] = 0.0
    d[1::6, 1] = -0.0
    alive = (rng.random(N) < 0.8).astype(np.int32)

    def tile(a):
        return jnp.asarray(a.reshape(SUBLANES, PACKET))

    s = {ch: tile(np.zeros(N, np.float32)) for ch in jmk._SORT_CH}
    s.update(ox=tile(o[:, 0]), oy=tile(o[:, 1]), oz=tile(o[:, 2]),
             dx=tile(d[:, 0]), dy=tile(d[:, 1]), dz=tile(d[:, 2]), alive=tile(alive))
    s["state"] = tile(np.zeros(N, np.uint32))
    keys = []
    monkeypatch.setattr(jmk, "sort_tile_by_key", lambda key, chans: (keys.append(key), chans))
    jmk._lane_sort(s, {"bbox": jcs.bbox_static})
    want = np.asarray(keys[0]).ravel()

    ps = {ch: torch.from_numpy(np.ascontiguousarray(v)) for ch, v in (
        ("ox", o[:, 0]), ("oy", o[:, 1]), ("oz", o[:, 2]),
        ("dx", d[:, 0]), ("dy", d[:, 1]), ("dz", d[:, 2]))}
    ps["alive"] = torch.from_numpy(alive.astype(np.float32))
    got = mk.lane_sort_key(ms, ps)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 100 and (want == DEAD).any()


def _meshbox():
    s = j_load(MESHBOX_SMALL)
    s.put_cbox_spheres()
    return s
