"""The hand-written CUDA kernels against their plain twins, on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA card.
This file imports neither jax nor hijiki_tpu, so it also runs where only
the port is installed (the H100 machine):

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -p no:cacheprovider

Bounds: K3 rtol 1e-5 / atol 1e-6 (expf ULPs); K1/K2 RNG state bit-equal and
radiance within 2e-3 on >= 99.5% of paths (built with --fmad=false, the
kernels round like the twin, which measured them bit-equal)."""

import numpy as np
import pytest
import torch

from hijiki_tpu_torch.ops import megakernel as mk
from hijiki_tpu_torch.render import pallas_reconstruct as prc
from hijiki_tpu_torch.render.reconstruct import reconstruct_sweep
from hijiki_tpu_torch.render.renderer import RenderConfig, Renderer
from hijiki_tpu_torch.scene.compile import compile_scene
from hijiki_tpu_torch.scene.obj import load_obj_scene
from hijiki_tpu_torch.scene.presets import load_preset
from torch_port_helpers import MESHBOX, MESHBOX_SMALL, cuda_device, frame_inputs

pytestmark = pytest.mark.cuda


def _scene(path):
    if path.startswith("builtin:"):
        return compile_scene(load_preset(path[8:]))
    s = load_obj_scene(path)
    s.put_cbox_spheres()
    return compile_scene(s)


def _frame(S, dev):
    px, py, seeds = frame_inputs(S, S, 0.37, 0.61, 2654435761)
    return (torch.from_numpy(px).to(dev), torch.from_numpy(py).to(dev),
            torch.from_numpy(seeds.view(np.int32)).to(dev))


def _agree(k, p):
    same = (k[1] == p[1]).cpu().numpy()
    close = np.isclose(k[0][15:18].T.cpu().numpy(), p[0][15:18].T.cpu().numpy(),
                       rtol=2e-3, atol=2e-3).all(-1)
    assert same.mean() >= 0.995 and (same & close).mean() >= 0.995


@pytest.mark.parametrize("H,W", [(1024, 1024), (256, 1000)])
def test_reconstruct_kernel_matches_twin(H, W):
    dev = cuda_device()
    rng = np.random.default_rng(H + W)
    color = (rng.random((H, W, 3)) * 2).astype(np.float32)
    color[rng.random((H, W)) < 1e-3] = np.nan
    normal = rng.standard_normal((H, W, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    so = rng.random(2).astype(np.float32)
    c, n = torch.from_numpy(color).to(dev), torch.from_numpy(normal).to(dev)
    before = prc.LAUNCHES["reconstruct"]
    got = prc.reconstruct(c, n, so, block_size=128)
    assert prc.LAUNCHES["reconstruct"] == before + 1
    want = reconstruct_sweep(c, n, torch.zeros_like(c), so, block_size=128)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("path", [MESHBOX, MESHBOX_SMALL, "builtin:cornell-glass"])
def test_megakernel_matches_twin(path):
    dev = cuda_device()
    S = 64
    ms = mk.mega_scene(_scene(path), S, S, dev)
    px, py, seeds = _frame(S, dev)
    before = dict(mk.LAUNCHES)
    k1 = mk.megakernel_start(ms, px, py, seeds, 5)
    k2 = mk.megakernel_resume(ms, k1[0], k1[1], 24)
    assert mk.LAUNCHES["mk_start"] == before["mk_start"] + 1
    assert mk.LAUNCHES["mk_resume"] == before["mk_resume"] + 1
    _agree(k1, mk.megakernel_start_plain(ms, px, py, seeds, 5))
    _agree(k2, mk.megakernel_resume_plain(ms, k1[0], k1[1], 24))


def test_phased_kernels_equal_single_launch():
    dev = cuda_device()
    S = 128
    ms = mk.mega_scene(_scene(MESHBOX), S, S, dev)
    px, py, seeds = _frame(S, dev)
    one = mk.render_tiles(ms, px, py, seeds, max_bounces=64)
    waves = mk.render_waves(ms, px, py, seeds, max_bounces=64, phase_bounces=(5, 12))
    assert int(waves[4]) == 0
    assert torch.equal(one[3], waves[3])
    assert torch.equal(one[0], waves[0])


def test_wrapper_rejects_bad_inputs():
    dev = cuda_device()
    ms = mk.mega_scene(_scene(MESHBOX_SMALL), 8, 8, dev)
    px, py, seeds = _frame(8, dev)
    with pytest.raises(ValueError):
        mk.megakernel_start(ms, px.double(), py, seeds, 5)
    with pytest.raises(ValueError):
        mk.megakernel_start(ms, px, py, seeds.to(torch.int64), 5)


def test_renderer_on_card_matches_twin_renderer():
    dev = cuda_device()
    cs = _scene(MESHBOX_SMALL)
    cfg = RenderConfig(width=64, height=64, spp=2, seed=5)
    a = Renderer(cs, cfg, device=dev)
    a.render()
    b = Renderer(cs, cfg, device="cpu")
    b.render()
    close = np.isclose(a.film.cpu().numpy(), b.film.numpy(), rtol=2e-3, atol=2e-3).all(-1)
    assert close.mean() >= 0.90
