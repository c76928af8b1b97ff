"""The megakernel's plain twin (hijiki_tpu_torch.ops.megakernel) against the
TPU megakernel of hijiki_tpu run in interpret mode. (The CUDA kernels K1
mk_start and K2 mk_resume are held against the twin on the card in
tests/test_torch_cuda.py.)

Bounds (tests/test_megakernel.py:46-54, 305-312): the final RNG state is
bit-equal on >= 99.5% of paths, and >= 99.5% of paths agree on both the RNG
state and the radiance within rtol/atol 2e-3. The few paths that may
differ are the silhouette/t-tie reroute class: XLA may contract a*b+c into
an FMA while the twin rounds every operation, so a grazing sphere or edge
hit can move by ULPs (docs/PARITY.md), and the TPU walks packets where the
port walks each lane."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hijiki_tpu.ops import pallas_megakernel as jmk
from hijiki_tpu.scene.compile import compile_scene as j_compile, scene_to_device
from hijiki_tpu.scene.obj import load_obj_scene as j_load
from hijiki_tpu_torch.ops import megakernel as mk
from torch_port_helpers import MESHBOX_SMALL, frame_inputs, mixed_scene, port_scene

W = H = 32


def _jax_scene(name):
    if name == "mixed":
        s = mixed_scene("hijiki_tpu")
    else:
        s = j_load(MESHBOX_SMALL)
        s.put_cbox_spheres()
    return j_compile(s, shadow_vis_boxes=False)


def _both(name):
    jcs = _jax_scene(name)
    return name, scene_to_device(jcs), mk.mega_scene(port_scene(jcs), W, H, "cpu")


@pytest.fixture(scope="module", params=["meshbox_small", "mixed"])
def scenes(request):
    return _both(request.param)


def _inputs():
    px, py, seeds = frame_inputs(W, H, 0.37, 0.61, 2654435761)
    return px, py, seeds


def _tt(px, py, seeds):
    return torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(seeds.view(np.int32))


def assert_paths_agree(rng_a, rng_b, total_a, total_b, frac=0.995):
    same = np.asarray(rng_a).astype(np.uint32) == np.asarray(rng_b).astype(np.uint32)
    close = np.isclose(np.asarray(total_a), np.asarray(total_b), rtol=2e-3, atol=2e-3).all(-1)
    assert same.mean() >= frac, f"RNG states differ on {1 - same.mean():.3%} of paths"
    assert (same & close).mean() >= frac, f"paths disagree: {1 - (same & close).mean():.3%}"


def test_render_tiles_matches_tpu_kernel(scenes):
    name, jcs, ms = scenes
    px, py, seeds = _inputs()
    jt = jmk.render_tiles(jcs, jnp.asarray(px), jnp.asarray(py), jnp.asarray(seeds),
                          width=W, height=H, max_bounces=24, interpret=True)
    total, normal, depth, state = mk.render_tiles(ms, *_tt(px, py, seeds), max_bounces=24)
    assert_paths_agree(jt[3], state, jt[0], total)
    hit = np.asarray(jt[2]) > 0
    # first hits: the same depth to f32 rounding on almost every path
    rel = np.abs(depth.numpy() - np.asarray(jt[2]))[hit] / np.asarray(jt[2])[hit]
    assert (rel < 1e-5).mean() >= 0.99
    assert float(total.mean()) > 0.01


def test_render_waves_matches_tpu_kernel():
    name, jcs, ms = _both("meshbox_small")
    px, py, seeds = _inputs()
    jw = jmk.render_waves(jcs, jnp.asarray(px), jnp.asarray(py), jnp.asarray(seeds),
                          width=W, height=H, max_bounces=24, phase_bounces=(6, 12),
                          interpret=True)
    tw = mk.render_waves(ms, *_tt(px, py, seeds), max_bounces=24, phase_bounces=(6, 12))
    assert int(jw[4]) == 0 and int(tw[4]) == 0
    assert_paths_agree(jw[3], tw[3], jw[0], tw[0])
    # per-path segment counts agree wherever the path did
    same = np.asarray(jw[3]) == tw[3].numpy().astype(np.uint32)
    np.testing.assert_array_equal(tw[5].numpy()[same], np.asarray(jw[5])[same])


def test_resume_from_tpu_phase0_state():
    """Carry the TPU kernel's phase-0 state (T, 29, 8, P) into the port with
    state_from_reference and resume it there: the paths finish as the TPU's
    one-launch render finishes them."""
    jcs = _jax_scene("meshbox_small")
    djcs = scene_to_device(jcs)
    ms = mk.mega_scene(port_scene(jcs), W, H, "cpu")
    px, py, seeds = _inputs()
    captured = {}
    real = jmk._run_compaction_phases

    def capture(scene, base_cfg, rows, caps, shrinks, flat, rngf, *a, **k):
        captured["flat"], captured["rng"] = np.asarray(flat), np.asarray(rngf)
        return real(scene, base_cfg, rows, caps, shrinks, flat, rngf, *a, **k)

    jmk._run_compaction_phases = capture
    try:  # the un-jitted function, so the captured state is concrete
        jmk.render_waves.__wrapped__(
            djcs, jnp.asarray(px), jnp.asarray(py), jnp.asarray(seeds), width=W, height=H,
            max_bounces=5, phase_bounces=(3,), interpret=True,
        )
    finally:
        jmk._run_compaction_phases = real
    flat = captured["flat"]  # (N_STATE, N) after 3 bounces
    st_ref = np.moveaxis(flat.reshape(mk.N_STATE, -1, 8, 128), 0, 1)
    rng_ref = captured["rng"].reshape(-1, 1, 8, 128)
    st, rng = mk.state_from_reference(st_ref, rng_ref)
    # the port's own phase 0 reaches the same state
    own_st, own_rng = mk.megakernel_start(ms, *_tt(px, py, seeds), 3)
    assert (own_rng.numpy() == rng.numpy()).mean() >= 0.995
    # ... and resuming the TPU's state finishes like the TPU's full render
    st2, rng2 = mk.megakernel_resume(ms, st, rng, 24)
    jt = jmk.render_tiles(djcs, jnp.asarray(px), jnp.asarray(py), jnp.asarray(seeds),
                          width=W, height=H, max_bounces=24, interpret=True)
    assert_paths_agree(jt[3], rng2, jt[0], st2[15:18].T.numpy())


def test_state_layout_roundtrip():
    rng = np.random.default_rng(0)
    st = rng.random((2, mk.N_STATE, 8, 128)).astype(np.float32)
    r = rng.integers(0, 1 << 32, size=(2, 1, 8, 128), dtype=np.uint64).astype(np.uint32)
    a, b = mk.state_from_reference(st, r)
    assert a.shape == (mk.N_STATE, 2048) and b.dtype == torch.int32
    st2, r2 = mk.state_to_reference(a, b)
    np.testing.assert_array_equal(st2, st)
    np.testing.assert_array_equal(r2, r)
    assert mk._STATE_CH == jmk._STATE_CH and mk._RESULT_CH == jmk._RESULT_CH


@pytest.mark.parametrize("mb,pb,ps,want", [
    (1000, (5, 12, 48), (2, 4, 4), ([5, 12, 48, 1000], [2, 4, 4])),
    (24, (6, 12), (2, 4, 4), ([6, 12, 24], [2, 4])),
    (4, (5, 12, 48), (2, 4, 4), ([4], [])),
    (40, (5, 12, 48), (1,) * 8, ([5, 12, 40], [1, 1])),
])
def test_phase_caps(mb, pb, ps, want):
    assert mk._phase_caps(mb, pb, ps) == want


def test_phased_equals_single_launch_and_counts_overflow():
    """Per-lane semantics make the phased driver path-for-path identical to
    one launch; undersized phases drop paths and count them."""
    jcs = _jax_scene("meshbox_small")
    S = 64
    ms = mk.mega_scene(port_scene(jcs), S, S, "cpu")
    px, py, seeds = frame_inputs(S, S, 0.5, 0.5, 747796405)
    args = _tt(px, py, seeds)
    one = mk.render_tiles(ms, *args, max_bounces=16)
    full = mk.render_waves(ms, *args, max_bounces=16, phase_bounces=(3, 8), phase_shrink=(1, 1))
    assert int(full[4]) == 0
    np.testing.assert_array_equal(full[3].numpy(), one[3].numpy())
    np.testing.assert_array_equal(full[0].numpy(), one[0].numpy())
    tight = mk.render_waves(ms, *args, max_bounces=16, phase_bounces=(1, 8), phase_shrink=(4, 4))
    n_alive = int((mk.megakernel_start(ms, *args, 1)[0][0] > 0).sum())
    assert int(tight[4]) == max(n_alive - 1024, 0) > 0


def test_cpu_twin_counts_no_launch():
    jcs = _jax_scene("meshbox_small")
    ms = mk.mega_scene(port_scene(jcs), 8, 8, "cpu")
    before = dict(mk.LAUNCHES)
    px, py, seeds = frame_inputs(8, 8, 0.5, 0.5, 3)
    mk.render_waves(ms, *_tt(px, py, seeds), max_bounces=4)
    assert mk.LAUNCHES == before
