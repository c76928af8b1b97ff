"""Reconstruction: the port's plain twin of the CUDA stencil (K3) against
hijiki_tpu's Pallas kernel (interpret mode) and its XLA formulation (the
kernel against the twin on the card: tests/test_torch_cuda.py).

Tolerance rtol 1e-5 / atol 1e-6: both sides compute the same f32 formula;
they differ only in exp() rounding and in where the spatial offset's
``- 0.5`` is applied (ULPs)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hijiki_tpu.render.pallas_reconstruct import reconstruct_pallas
from hijiki_tpu.render.reconstruct import reconstruct_sweep as j_reconstruct_sweep
from hijiki_tpu_torch.render import pallas_reconstruct as prc
from hijiki_tpu_torch.render.reconstruct import normalize_film, reconstruct_sweep

CASES = [
    # (H, W, block, seed, nan fraction)
    (64, 64, 64, 0, 0.0),
    (72, 100, 64, 1, 0.02),  # partial blocks: right/bottom spill + NaN rejection
    (40, 136, 128, 2, 0.01),  # one partial 128 block, width not a multiple
]


def _inputs(H, W, seed, nan_frac):
    rng = np.random.default_rng(seed)
    color = (rng.random((H, W, 3)) * 3.0).astype(np.float32)
    color[rng.random((H, W)) < nan_frac] = np.nan
    normal = rng.standard_normal((H, W, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    normal[rng.random((H, W)) < 0.1] = 0.0  # background pixels
    so = rng.random(2).astype(np.float32)
    return color, normal, so


@pytest.mark.parametrize("H,W,B,seed,nan_frac", CASES)
def test_twin_matches_pallas_kernel(H, W, B, seed, nan_frac):
    color, normal, so = _inputs(H, W, seed, nan_frac)
    want = np.asarray(reconstruct_pallas(
        jnp.asarray(color), jnp.asarray(normal), jnp.asarray(so),
        block_size=B, interpret=True,
    ))
    got = prc.reconstruct(torch.from_numpy(color), torch.from_numpy(normal), so, block_size=B)
    assert got.shape == (H, W, 4)
    assert np.isfinite(got.numpy()).all()  # NaN samples are rejected
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("H,W,B,seed,nan_frac", CASES)
def test_twin_matches_xla_reconstruct_sweep(H, W, B, seed, nan_frac):
    color, normal, so = _inputs(H, W, seed, nan_frac)
    alb = np.zeros_like(color)
    want = np.asarray(j_reconstruct_sweep(
        jnp.asarray(color), jnp.asarray(normal), jnp.asarray(alb), jnp.asarray(so),
        block_size=B,
    ))
    got = reconstruct_sweep(
        torch.from_numpy(color), torch.from_numpy(normal), torch.from_numpy(alb), so,
        block_size=B,
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_nonzero_albedo_and_radius_match():
    """The general-radius, albedo-term path of the twin (not on the slice,
    kept exact for the later fixed-albedo port)."""
    color, normal, so = _inputs(48, 80, 5, 0.0)
    alb = np.random.default_rng(5).random((48, 80, 3)).astype(np.float32)
    want = np.asarray(j_reconstruct_sweep(
        jnp.asarray(color), jnp.asarray(normal), jnp.asarray(alb), jnp.asarray(so),
        block_size=64, radius=3, stddev=0.7,
    ))
    got = reconstruct_sweep(
        torch.from_numpy(color), torch.from_numpy(normal), torch.from_numpy(alb), so,
        block_size=64, radius=3, stddev=0.7,
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_normalize_film():
    film = torch.tensor([[[2.0, 4.0, 6.0, 2.0]]])
    np.testing.assert_array_equal(normalize_film(film).numpy(), [[[1.0, 2.0, 3.0]]])


def test_cpu_twin_counts_no_launch():
    before = dict(prc.LAUNCHES)
    color, normal, so = _inputs(16, 16, 9, 0.0)
    prc.reconstruct(torch.from_numpy(color), torch.from_numpy(normal), so, block_size=64)
    assert prc.LAUNCHES == before
