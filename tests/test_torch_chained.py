"""The chained path: the K4 twin (``megakernel_start_chained_plain``) and
``render_waves_chained`` of hijiki_tpu_torch against hijiki_tpu's chained
TPU kernel in interpret mode, and against separate sweeps of the port.

Bounds. Against the TPU kernel, the megakernel bounds of
test_torch_megakernel.py: >= 99.5% of samples agree, on radiance within
rtol/atol 2e-3 (the silhouette/t-tie reroute class) and on a bit-equal RNG
wherever the TPU kernel returns one: it leaves a sample that finished
inside the chained launch at RNG 0 and returns the final RNG of the parked
ones only (the port returns every sample's final RNG). Against separate
``render_waves`` sweeps of the port: bit-equal in every output, since each
thread walks alone and no packet composition exists."""

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
S = 3


def _jax_scene(name):
    if name == "mixed":
        s = mixed_scene("hijiki_tpu")
    else:
        s = j_load(MESHBOX_SMALL)
        s.put_cbox_spheres()
    return j_compile(s, shadow_vis_boxes=False)


@pytest.fixture(scope="module", params=["meshbox_small", "mixed"])
def scenes(request):
    jcs = _jax_scene(request.param)
    return scene_to_device(jcs), mk.mega_scene(port_scene(jcs), W, H, "cpu")


@pytest.fixture(scope="module")
def meshbox():
    return mk.mega_scene(port_scene(_jax_scene("meshbox_small")), W, H, "cpu")


def chained_inputs(n_sweeps=S, seed=5):
    """(S, N) jittered pixel coordinates and per-(sweep, pixel) seeds, as
    numpy arrays (tests/test_megakernel.py:497-509)."""
    rng = np.random.default_rng(seed)
    px, py, _ = frame_inputs(W, H, 0.0, 0.0, 1)
    pxs, pys, sds = [], [], []
    for s in range(n_sweeps):
        ox, oy = rng.random(2, dtype=np.float32)
        pxs.append(px + ox)
        pys.append(py + oy)
        sds.append(((np.arange(W * H) * 2654435761 + s * 977) % (1 << 32)).astype(np.uint32))
    return np.stack(pxs), np.stack(pys), np.stack(sds)


def _tt(pxs, pys, sds):
    return torch.from_numpy(pxs), torch.from_numpy(pys), torch.from_numpy(sds.view(np.int32))


def test_chained_twin_matches_tpu_kernel(scenes):
    jcs, ms = scenes
    pxs, pys, sds = chained_inputs()
    jc = jmk.render_waves_chained(
        jcs, jnp.asarray(pxs), jnp.asarray(pys), jnp.asarray(sds), width=W, height=H,
        max_bounces=24, chain_cap=8, interpret=True,
    )
    tc = mk.render_waves_chained(ms, *_tt(pxs, pys, sds), max_bounces=24, chain_cap=8)
    assert int(jc[4]) == 0 and int(tc[4]) == 0
    close = np.isclose(np.asarray(jc[0]), tc[0].numpy(), rtol=2e-3, atol=2e-3).all(-1)
    assert close.mean() >= 0.995, f"radiance differs on {1 - close.mean():.3%} of samples"
    js, ts = np.asarray(jc[3]), tc[3].numpy().view(np.uint32)
    parked = js != 0
    assert parked.any()
    # a path agrees when its radiance does and, where the TPU kernel
    # returns its RNG, the RNG is bit-equal
    same = ~parked | (js == ts)
    # ... and on its segment count (a rerouted path may still end with the
    # same radiance, e.g. 0)
    agree = same & close & (tc[5].numpy() == np.asarray(jc[5]))
    assert agree.mean() >= 0.995, f"samples disagree: {1 - agree.mean():.3%}"
    # albedo agrees on those paths; interpolated normals of the smooth torus
    # move by up to ~5e-4 where XLA contracts a*b+c (as in
    # test_torch_megakernel.py); first hits to f32 rounding
    np.testing.assert_allclose(tc[7].numpy()[agree], np.asarray(jc[7])[agree], atol=1e-6)
    np.testing.assert_allclose(tc[1].numpy()[agree], np.asarray(jc[1])[agree], atol=1e-3)
    jd, td = np.asarray(jc[2]), tc[2].numpy()
    hit = jd > 0
    assert (np.abs(td - jd)[hit] / jd[hit] < 1e-5).mean() >= 0.99
    assert float(tc[0].mean()) > 0.01


def test_chained_equals_separate_sweeps(scenes):
    """The chained driver's exactness: respawn, park and commit must not move
    any sample. Chained is bit-equal per sweep to separate render_waves
    calls in total, normal, depth, RNG, segs and albedo; rows summed."""
    _, ms = scenes
    args = _tt(*chained_inputs())
    ch = mk.render_waves_chained(ms, *args, max_bounces=24, chain_cap=8)
    refs = [mk.render_waves(ms, *(a[s] for a in args), max_bounces=24) for s in range(S)]
    assert int(ch[4]) == 0
    assert bool((ch[5] > 8).any())  # some samples parked and were resumed
    for i in (0, 1, 2, 3, 5, 7):
        for s in range(S):
            assert torch.equal(ch[i][s], refs[s][i]), (i, s)
    assert torch.equal(ch[6], sum(r[6] for r in refs))


def test_chained_overflow_counter_reports_drops(meshbox):
    """A tiny chain cap with a tiny resume capacity overflows and says so;
    each dropped sample stays 0 in its sweep image (the renderer's retry is
    what restores it), and nothing else moves."""
    pxs, pys, sds = chained_inputs(2)
    args = _tt(pxs, pys, sds)
    tight = mk.render_waves_chained(meshbox, *args, max_bounces=40, chain_cap=1,
                                    phase_shrink=(64,))
    full = mk.render_waves_chained(meshbox, *args, max_bounces=40, chain_cap=1,
                                   phase_shrink=(1,))
    assert int(full[4]) == 0
    ovf = int(tight[4])
    assert ovf > 0
    dropped = (tight[5] == 0) & (full[5] > 0)
    assert int(dropped.sum()) == ovf
    assert bool((tight[0][dropped] == 0).all())
    assert torch.equal(tight[0][~dropped], full[0][~dropped])


def test_chained_phase_normalization(meshbox):
    """tests/test_megakernel.py:553-587: a non-monotonic resume cap is
    dropped, and a cap at or below the chain cap takes its shrink with it."""
    pxs, pys, sds = chained_inputs(2)
    args = _tt(pxs, pys, sds)

    def run(**kw):
        return mk.render_waves_chained(meshbox, *args, max_bounces=40, chain_cap=8, **kw)

    ref = run(phase_bounces=(48,))
    for kw in (dict(phase_bounces=(48, 24)), dict(phase_bounces=(4, 48), phase_shrink=(9999, 1))):
        out = run(**kw)
        assert int(out[4]) == 0
        assert torch.equal(out[0], ref[0])


@pytest.mark.parametrize("mb,cap0,pb,ps,want", [
    (1000, 8, (48,), (4,), ([48, 1000], [4, 4])),
    (40, 8, (48,), (4,), ([40], [4])),
    (40, 8, (48, 24), (4,), ([40], [4])),
    (40, 8, (4, 48), (9999, 1), ([40], [1])),
    (8, 8, (48,), (4,), ([], [])),
    (1000, 2, (), (), ([1000], [4])),
])
def test_chain_caps(mb, cap0, pb, ps, want):
    assert mk._chain_caps(mb, cap0, pb, ps) == want


def test_direct_commit_when_max_bounces_le_chain_cap(meshbox):
    """max_bounces <= chain_cap: no resume phase; the parked pool commits
    directly and every sample is final."""
    args = _tt(*chained_inputs())
    pool = mk.megakernel_start_chained_plain(meshbox, *args, 6)[0]
    assert int((pool[0] > 0).sum()) > 0  # paths alive at the cap exist
    ch = mk.render_waves_chained(meshbox, *args, max_bounces=6, chain_cap=8)
    assert int(ch[4]) == 0
    for s in range(S):
        ref = mk.render_waves(meshbox, *(a[s] for a in args), max_bounces=6)
        for i in (0, 3, 5):
            assert torch.equal(ch[i][s], ref[i])


def test_commit_drops_out_of_bounds_slots():
    """JAX's scatter drops updates at orig == n; the port sends them to the
    trash column, on an empty-slot-heavy pool, and leaves the slots alone."""
    n = 4096
    gen = torch.Generator().manual_seed(0)
    flat = torch.rand((mk.N_STATE, n), generator=gen)
    rngf = torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32, generator=gen)
    keep = torch.zeros(n, dtype=torch.bool)
    keep[::97] = True
    orig = torch.where(keep, torch.arange(n), n)
    base = torch.rand((mk.CHAIN_OUT_CH, n), generator=gen)
    res, res_state = mk._with_trash_column(base, torch.zeros(n, dtype=torch.int32))
    mk._commit(res, res_state, orig, flat[list(mk._RESULT_CH)], rngf)
    assert torch.equal(res[:, :n][:, ~keep], base[:, ~keep])
    assert torch.equal(res[:, :n][:, keep], flat[list(mk._RESULT_CH)][:, keep])
    assert torch.equal(res_state[:n][keep], rngf[keep])
    assert bool((res_state[:n][~keep] == 0).all())


def test_chained_twin_layout_and_counts_no_launch(meshbox):
    """The K4 twin's (C, S*N) outputs: each slot is parked XOR flushed, the
    parked state carries its sample index; a CPU call launches nothing."""
    before = dict(mk.LAUNCHES)
    pxs, pys, sds = _tt(*chained_inputs())
    pool, prng, co = mk.megakernel_start_chained(meshbox, pxs, pys, sds, 4)
    assert mk.LAUNCHES == before
    n = W * H
    assert pool.shape == (mk.N_STATE, S * n) and co.shape == (mk.CHAIN_OUT_CH, S * n)
    parked = pool[0] > 0
    assert bool(parked.any()) and bool((co[:, parked] == 0).all())
    assert bool((co[7][~parked] > 0).all())  # every flushed sample has segs
    samp = torch.arange(S * n) // n
    assert torch.equal(pool[28][parked], samp[parked].float())


def test_tiles_twin_equals_start_twin_at_full_cap(scenes):
    """K5's twin is K1's at cap max_bounces, restricted to its 7 result
    channels (K5's twin against hijiki_tpu's render_tiles is
    test_torch_megakernel.py::test_render_tiles_matches_tpu_kernel)."""
    _, ms = scenes
    px, py, seeds = frame_inputs(16, 16, 0.37, 0.61, 2654435761)
    args = (torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(seeds.view(np.int32)))
    out, rng = mk.megakernel_tiles(ms, *args, 24)
    st, rng1 = mk.megakernel_start_plain(ms, *args, 24)
    assert torch.equal(rng, rng1)
    assert torch.equal(out, st[[15, 16, 17, 20, 21, 22, 19]])
