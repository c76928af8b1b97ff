"""K10b over the packed trace-row tables: the walk probe's plain version
(hijiki_tpu_torch/probes/walk_probe.py::walk_isolate_plain, which the card
holds its kernel to) against tools/walk_probe.py's make_runner in interpret
mode, on meshbox_small + spheres compiled with packed_leaf 1, 3, 4 and 12
(the tool's slim, pack3 and packed = pack4 variants, and PACKED12, which the
port also has), with and without the prim test (patch_no_test)."""

import functools

import numpy as np
import pytest
import torch

from hijiki_tpu_torch.probes import walk_probe as W
from test_torch_probes import T, _interpret
from torch_port_helpers import MESHBOX_SMALL, port_scene


@functools.lru_cache(maxsize=4)
def _jax_packed_scene(leaf):
    from hijiki_tpu.scene.compile import compile_scene
    from hijiki_tpu.scene.obj import load_obj_scene

    scene = load_obj_scene(MESHBOX_SMALL)
    scene.put_cbox_spheres()
    return compile_scene(scene, packed_leaf=leaf)


@pytest.mark.parametrize("leaf", [1, 3, 4, 12])
@pytest.mark.parametrize("test", [True, False], ids=["test", "notest"])
def test_walk_probe_packed_matches_jax(monkeypatch, leaf, test):
    """The packed tables (the tool's slim, pack3, packed = pack4, and
    PACKED12): the plain version at G = 1 finds the tool's hits, with t
    within the classic test's rtol on every ray and bit for bit on >= 99%
    of the rays a packed row answers (XLA's interpret mode contracts some
    products: 2 of 739 such rays read 1 ULP apart on PACKED4; where an
    analytic sphere answers, ~9% of the rays, with and without the prim
    test, it differs by 1 ULP more often). The packet walk (G = 32) finds
    the same t over more rows."""
    import hijiki_tpu.ops.pallas_megakernel as mk
    from hijiki_tpu.scene.compile import scene_to_device
    from hijiki_tpu_torch.ops import megakernel as pmk

    wp = _interpret(monkeypatch, "walk_probe")
    monkeypatch.setattr(wp, "P", 128)
    monkeypatch.setattr(mk, "_prim_test", mk._prim_test)  # restored after the test
    jcs = _jax_packed_scene(leaf)
    assert jcs.mega_packed_static == leaf
    if not test:
        wp.patch_no_test()
    cs = scene_to_device(jcs)
    o, d = wp.camera_rays_np(cs, 32, 32)
    want_t, _ = wp.make_runner(cs, 4)(o, d)
    ms = pmk.mega_scene(port_scene(jcs), 32, 32, "cpu")
    o, d = T(np.asarray(o)), T(np.asarray(d))
    got_t, got_n = W.walk_isolate(ms, ms.rows, o, d, test=test)
    want_t = np.asarray(want_t).reshape(-1)
    np.testing.assert_array_equal(got_t.numpy() > 1e30, want_t > 1e30)
    sphere = torch.full((o.shape[1],), np.float32(pmk.BIG))  # the analytic pretest alone
    for k in range(ms.n_analytic):
        phit, pt, _, _ = pmk._analytic_test(ms.analytic[k], tuple(o), tuple(d),
                                            np.float32(1e-4), sphere)
        sphere = torch.where(phit & (pt < sphere), pt, sphere)
    row = (got_t != sphere).numpy()
    assert row.sum() > 0.5 * (want_t < 1e30).sum() if test else row.sum() == 0
    same = got_t.numpy()[row].view(np.int32) == want_t[row].view(np.int32)
    assert same.mean() >= 0.99 if test else True
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=5e-5)
    pk_t, pk_n = W.walk_isolate(ms, ms.rows, o, d, test=test, group=32)
    assert torch.equal(pk_t, got_t)
    assert (pk_n >= got_n).all() and pk_n.mean() > got_n.mean()
