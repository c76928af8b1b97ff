"""The port's scalar oracle (ops/oracle.py, numpy) and its native twin
(ops/oracle_native.py with ops/oracle_native.cpp) against the JAX package's,
bit for bit on the same inputs; native against numpy within 1e-12 MSE (the
libm-vs-numpy 1-ulp class of tests/test_oracle_native.py); and the port's
drivers against the port's oracle at equal seeds on the CPU twins, to the
bar chip_smoke.py's phase (r) holds the card's kernels to (raw MSE < 1e-4,
at most 1% of the pixels divergent, trimmed MSE <= 1e-8)."""

import os
import sys

import numpy as np
import pytest
import torch

from hijiki_tpu.ops.oracle import integrate_ray_oracle as j_integrate_ray_oracle
from hijiki_tpu.ops.oracle_native import render_oracle_native as j_render_oracle_native
from hijiki_tpu.scene.compile import compile_scene as j_compile
from hijiki_tpu.scene.obj import load_obj_scene as j_load
from hijiki_tpu_torch.ops.camera import camera_rays
from hijiki_tpu_torch.ops.oracle import integrate_ray_oracle
from hijiki_tpu_torch.ops.oracle_native import render_oracle_native
from hijiki_tpu_torch.scene.compile import compile_scene, to_device
from hijiki_tpu_torch.scene.obj import load_obj_scene
from torch_port_helpers import MESHBOX_SMALL, REPO, port_scene

sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the equal-seed gate's helpers)

RAYS = 32
# the gate on the CPU twins: meshbox_small + spheres, SIDE² pixels, SPP
# sweeps of BlockScheduler(SIDE, SIDE, 64, seed 0)
SIDE, SPP = 16, 4


def _jax_scene(name):
    """One scene compiled by the JAX package (its defaults)."""
    if name == "meshbox_small":
        s = j_load(MESHBOX_SMALL)
        s.put_cbox_spheres()
    else:
        from test_fuzz_oracle import random_scene

        s = random_scene(int(name.split("_")[1]))
    return j_compile(s)


def _camera_rays(cs, n, side, seed):
    """n jittered camera rays of a side² frame (numpy o, d) by the port's
    camera, and their path seeds."""
    rng = np.random.default_rng(seed)
    pxy = (rng.random((n, 2)) * side).astype(np.float32)
    d = to_device(cs, "cpu")
    o, dirs, _, _ = camera_rays(d.cam_position, d.cam_rotation, d.cam_fov,
                                torch.from_numpy(pxy), (side, side))
    return o.numpy(), dirs.numpy(), rng.integers(0, 1 << 32, n, dtype=np.uint32)


@pytest.mark.parametrize("name", ["meshbox_small", "random_11", "random_22"])
def test_numpy_oracle_bit_equal_to_jax(name):
    """integrate_ray_oracle on the same rays and seeds: total, normal,
    depth, final RNG state and draws, bit for bit."""
    jcs = _jax_scene(name)
    pcs = port_scene(jcs)
    o, d, seeds = _camera_rays(pcs, RAYS, 64, 5)
    draws = 0
    for i in range(RAYS):
        want = j_integrate_ray_oracle(jcs, o[i], d[i], int(seeds[i]))
        got = integrate_ray_oracle(pcs, o[i], d[i], int(seeds[i]))
        for k in ("total", "normal", "depth"):
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"ray {i} {k}")
        assert got["state"] == want["state"] and got["draws"] == want["draws"], i
        draws += got["draws"]
    assert draws > 2 * RAYS  # the paths bounce, sample lights and roulette


def test_numpy_oracle_takes_tensor_scene():
    """A scene of tensors (to_device) gives the numpy scene's paths."""
    pcs = port_scene(_jax_scene("meshbox_small"))
    o, d, seeds = _camera_rays(pcs, 4, 64, 9)
    dev = to_device(pcs, "cpu")
    for i in range(4):
        a = integrate_ray_oracle(pcs, o[i], d[i], int(seeds[i]))
        b = integrate_ray_oracle(dev, o[i], d[i], int(seeds[i]))
        np.testing.assert_array_equal(a["total"], b["total"])
        assert a["state"] == b["state"]


def _sweeps(side, spp, seed):
    return chip_smoke.equal_seed_inputs(side, spp, seed)


def test_native_oracle_bit_equal_to_jax():
    """render_oracle_native on a 16² film of 4 sweeps: the port's (on its own
    compile, and on that scene as CPU tensors) equals JAX's bit for bit."""
    seeds, offsets = _sweeps(16, 4, 3)
    want = j_render_oracle_native(_jax_scene("meshbox_small"), seeds, offsets, 16, 16)
    s = load_obj_scene(MESHBOX_SMALL)
    s.put_cbox_spheres()
    cs = compile_scene(s)
    got = render_oracle_native(cs, seeds, offsets, 16, 16)
    assert got.dtype == np.float64 and got.shape == (16, 16, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(render_oracle_native(to_device(cs, "cpu"), seeds, offsets,
                                                       16, 16), want)
    # accumulating into a given film adds
    acc = render_oracle_native(cs, seeds[:2], offsets[:2], 16, 16)
    render_oracle_native(cs, seeds[2:], offsets[2:], 16, 16, acc=acc)
    np.testing.assert_allclose(acc, want, rtol=1e-15, atol=0)


@pytest.mark.parametrize("name,side", [("meshbox_small", 12), ("random_33", 16)])
def test_native_oracle_matches_numpy_oracle(name, side):
    """The native film against the numpy oracle's paths through the native
    oracle's own camera (tools/oracle_mse.py's camera_ray), one sweep:
    MSE <= 1e-12, most values bitwise."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import oracle_mse as om

    pcs = port_scene(_jax_scene(name))
    seeds, offsets = _sweeps(side, 1, 4)
    F = np.float32
    acc = np.zeros((side, side, 3), np.float64)
    for y in range(side):
        for x in range(side):
            o, d = om.camera_ray(pcs.camera_static, F(x) + offsets[0, 0], F(y) + offsets[0, 1],
                                 side, side)
            acc[y, x] = integrate_ray_oracle(pcs, o, d, int(seeds[0, y * side + x]))["total"]
    got = render_oracle_native(pcs, seeds, offsets, side, side)
    mse = float(((got - acc) ** 2).mean())
    print(f"{name}: native vs numpy oracle MSE {mse:.3e}, bitwise {(got == acc).mean():.3f}")
    assert mse <= 1e-12, mse
    assert (got == acc).mean() > 0.5


@pytest.fixture(scope="module")
def gate_films():
    """The oracle's film and the drivers' films (CPU twins; the sync one
    also from the megakernel's camera, the oracle's) at equal seeds, as
    chip_smoke.py's phase (r) draws and renders them."""
    s = load_obj_scene(MESHBOX_SMALL)
    s.put_cbox_spheres()
    cs = compile_scene(s)
    seeds, offsets = _sweeps(SIDE, SPP, 0)
    films = chip_smoke.driver_films(cs, seeds, offsets, SIDE, "cpu", chain=SPP)
    films["oracle"] = chip_smoke.oracle_film(cs, seeds, offsets, SIDE)
    return films


@pytest.mark.parametrize("pair", ["oracle-chained", "oracle-unchained", "oracle-sync",
                                  "chained-sync", "oracle-sync_mega_camera"])
def test_drivers_meet_oracle_bar(gate_films, pair):
    a, b = (gate_films[k] for k in pair.split("-"))
    assert np.isfinite(b).all() and b.mean() > 0
    r = chip_smoke.readings(a, b)
    print(f"{pair} at {SIDE}x{SIDE} x {SPP} spp: raw MSE {r[0]:.3e}, divergent pixels "
          f"{r[1]}/{SIDE * SIDE}, trimmed MSE {r[2]:.3e}")
    assert chip_smoke.breaks_bar(r, SIDE * SIDE) == ""


def test_bar_rejects():
    """The bar itself: each of its three readings can fail it."""
    n = 64 * 64
    assert chip_smoke.breaks_bar((0.0, 0, 0.0), n) == ""
    assert chip_smoke.breaks_bar((0.0, 40, 0.0), n) == ""
    assert "divergent" in chip_smoke.breaks_bar((0.0, 41, 0.0), n)
    assert "raw MSE" in chip_smoke.breaks_bar((1e-4, 0, 0.0), n)
    assert "trimmed" in chip_smoke.breaks_bar((0.0, 0, 2e-8), n)
    a = np.zeros((4, 4, 3))
    b = a.copy()
    b[0, 0] = 1e-2  # one divergent pixel
    b[1, 1] = 1e-5  # f32-noise scale
    mse, n_div, trimmed = chip_smoke.readings(a, b)
    assert n_div == 1 and trimmed == pytest.approx(1e-10 / 16 * 16 / 15)
    assert mse == pytest.approx((1e-4 + 1e-10) / 16)
