"""Camera rays, the block scheduler and the per-pixel seed expansion of the
port against hijiki_tpu."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hijiki_tpu.ops.camera import camera_rays as j_camera_rays
from hijiki_tpu.render import blocks as jblocks
from hijiki_tpu_torch.ops.camera import camera_rays
from hijiki_tpu_torch.render import blocks as tblocks
from hijiki_tpu_torch.scene.model import Camera


@pytest.mark.parametrize("W,H", [(32, 32), (64, 48), (200, 130)])
def test_camera_rays_match(W, H):
    cam = Camera.cbox_default()
    rng = np.random.default_rng(W * H)
    pxy = (np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1) + rng.random((H, W, 2))).astype(np.float32)
    jo, jd, jtmin, jtmax = j_camera_rays(
        jnp.asarray(cam.position), jnp.asarray(cam.rotation), jnp.float32(cam.fov),
        jnp.asarray(pxy), jnp.asarray([W, H], jnp.float32),
    )
    o, d, tmin, tmax = camera_rays(
        torch.from_numpy(cam.position), torch.from_numpy(cam.rotation),
        np.float32(cam.fov), torch.from_numpy(pxy), (W, H),
    )
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(jtmin))
    assert np.isinf(tmax.numpy()).all() and np.isinf(np.asarray(jtmax)).all()


def test_megakernel_camera_matches_reference_camera():
    """The megakernel's baked-matrix camera (_camera_ray) agrees with the
    quaternion camera to f32 rounding."""
    from hijiki_tpu_torch.ops.megakernel import _camera_ray, mega_scene
    from hijiki_tpu_torch.scene.compile import compile_scene
    from hijiki_tpu_torch.scene.presets import load_preset

    W = H = 40
    cs = compile_scene(load_preset("cornell"))
    ms = mega_scene(cs, W, H, "cpu")
    pxy = (np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1) + 0.25).astype(np.float32).reshape(-1, 2)
    d = torch.stack(_camera_ray(ms, torch.from_numpy(pxy[:, 0]), torch.from_numpy(pxy[:, 1])), -1)
    _, d_ref, _, _ = camera_rays(
        torch.from_numpy(cs.cam_position), torch.from_numpy(cs.cam_rotation),
        cs.cam_fov, torch.from_numpy(pxy), (W, H),
    )
    np.testing.assert_allclose(d.numpy(), d_ref.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 42, -1, 2**63 + 5])
def test_block_scheduler_identical(seed):
    a = jblocks.BlockScheduler(300, 200, 128, seed)
    b = tblocks.BlockScheduler(300, 200, 128, seed)
    for i in range(3):
        sa, sb = a.sweep(i), b.sweep(i)
        np.testing.assert_array_equal(sa.sample_offset, sb.sample_offset)
        np.testing.assert_array_equal(sa.block_seeds, sb.block_seeds)


@pytest.mark.parametrize("W,H,B", [(128, 128, 128), (200, 130, 64), (1000, 70, 128), (64, 1, 64)])
def test_per_pixel_seeds_bitexact(W, H, B):
    bs = tblocks.BlockScheduler(W, H, B, 7).sweep(0).block_seeds
    bs[0, 0] = 0xFFFFFFF0  # the sum wraps past 2^32
    want = np.asarray(jblocks.per_pixel_seeds_device(W, H, B, jnp.asarray(bs)))
    got = tblocks.per_pixel_seeds_device(W, H, B, bs, "cpu")
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(tblocks.per_pixel_seeds(W, H, B, bs), want)
    assert got.dtype == torch.int64 and int(got.max()) <= 0xFFFFFFFF


@pytest.mark.parametrize("W,H,B", [(200, 130, 64), (64, 1, 64)])
def test_per_pixel_seeds_batched_over_sweeps(W, H, B):
    """A chained chunk expands its sweeps' block seeds in one call: each
    (H, W) slice equals the JAX expansion of that sweep alone."""
    sched = tblocks.BlockScheduler(W, H, B, 3)
    bs = np.stack([sched.sweep(i).block_seeds for i in range(3)])
    got = tblocks.per_pixel_seeds_device(W, H, B, bs, "cpu")
    assert got.shape == (3, H, W)
    for s in range(3):
        want = np.asarray(jblocks.per_pixel_seeds_device(W, H, B, jnp.asarray(bs[s])))
        np.testing.assert_array_equal(got[s].numpy().astype(np.uint32), want)


def test_block_size_must_be_multiple_of_64():
    with pytest.raises(ValueError):
        tblocks.BlockScheduler(64, 64, 100, 0)
