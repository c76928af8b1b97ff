"""hijiki_tpu_torch.parallel.multihost on the CPU: the host stride of the
sweeps, simulated (explicit host ids, merged with merge_films) and in two
real processes over torch.distributed (gloo, a file:// store in the test's
own directory, so parallel test workers never share a port).

Bounds. Simulated hosts on one device against the single render: rtol
1e-6 / atol 1e-7 (the same per-sweep deltas, added in another order).
The stride over sharded bases and the two-process runs: rtol 1e-4 / atol
2e-4 (tests/test_multichip.py:191-224, tests/test_multihost_distributed.py).
Against JAX's simulated merge: rtol 1e-4 / atol 2e-4 (the sync films of
the two packages differ by XLA's and torch's float rounding: the port's
single film holds JAX's merge at rtol 1e-6 on ~80% of pixels only) on
every pixel where the port's single film agrees with it, >= 95% of the
pixels (the single-device reroute class, see test_torch_multichip.py,
over 5 sweeps here: measured 97.3%).
Checkpoint resume: bit for bit."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from hijiki_tpu.parallel.multihost import MultiHostRenderer as JMultiHostRenderer
from hijiki_tpu.parallel.multihost import merge_films as j_merge_films
from hijiki_tpu.render.renderer import RenderConfig as JConfig
from hijiki_tpu.scene.compile import compile_scene as j_compile
from hijiki_tpu.scene.obj import load_obj_scene as j_load
from hijiki_tpu_torch.parallel import multihost as mh
from hijiki_tpu_torch.render.renderer import RenderConfig, Renderer
from torch_port_helpers import MESHBOX_SMALL, REPO, port_scene


@pytest.fixture(scope="module")
def scenes():
    s = j_load(MESHBOX_SMALL)
    s.put_cbox_spheres()
    jcs = j_compile(s, shadow_vis_boxes=False)
    return jcs, port_scene(jcs)


def test_host_sweeps_partition():
    for spp, n in ((5, 3), (8, 2), (2, 4), (1, 1)):
        ids = [mh.host_sweeps(spp, h, n) for h in range(n)]
        assert sorted(sum(ids, [])) == list(range(spp))
        assert all(i % n == h for h in range(n) for i in ids[h])
    for h, n in ((3, 3), (-1, 2)):
        with pytest.raises(ValueError, match="outside"):
            mh.host_sweeps(4, h, n)


def test_simulated_hosts_merge_to_single_and_jax(scenes):
    """Three hosts, each tracing its stride of 5 sweeps (one holds 1 sweep
    fewer), merged; the single-process merged_film() is the local film."""
    jcs, cs = scenes
    kw = dict(width=128, height=64, spp=5, block_size=64, seed=11, max_bounces=6)
    cfg = RenderConfig(driver="sync", **kw)
    single = Renderer(cs, cfg, device="cpu")
    single.render()
    hosts = [mh.MultiHostRenderer(cs, cfg, host_id=h, num_hosts=3, device="cpu") for h in range(3)]
    for h in hosts:
        m = h.render()
        assert m["sweeps"] == len(mh.host_sweeps(5, h.host_id, 3)) == h.sweeps_done
        assert m["primary_rays"] == 128 * 64 * m["sweeps"]
    merged = mh.merge_films([h.film for h in hosts]).numpy()
    np.testing.assert_allclose(merged, single.film.numpy(), rtol=1e-6, atol=1e-7)
    assert np.array_equal(hosts[0].merged_film().numpy(), hosts[0].film.numpy())
    assert hosts[0].num_hosts == 3 and mh.MultiHostRenderer(cs, cfg, device="cpu").num_hosts == 1

    jhosts = [JMultiHostRenderer(jcs, JConfig(**kw), host_id=h, num_hosts=3) for h in range(3)]
    for h in jhosts:
        h.render()
    jmerged = np.asarray(j_merge_films([h.film for h in jhosts]))
    bounds = dict(rtol=1e-4, atol=2e-4)
    close = np.isclose(single.film.numpy(), jmerged, **bounds).all(-1)
    assert close.mean() >= 0.95, f"single film agrees with JAX's merge on {close.mean():.2%}"
    assert np.isclose(merged, jmerged, **bounds).all(-1)[close].all()


def test_multihost_checkpoint_resume(scenes, tmp_path):
    """tests/test_multichip.py:143-173: a host's checkpoint holds its film and
    its count of finished sweeps; resuming with the same split continues
    there, bit-equal to the uninterrupted host."""
    _, cs = scenes
    cfg = RenderConfig(width=64, height=64, spp=6, block_size=64, seed=3, max_bounces=4,
                       driver="sync")
    full = mh.MultiHostRenderer(cs, cfg, host_id=1, num_hosts=2, device="cpu")
    full.render()
    part = mh.MultiHostRenderer(cs, dataclasses.replace(cfg, spp=2), host_id=1, num_hosts=2,
                                device="cpu")
    part.render()
    assert part.sweeps_done == 1
    ck = str(tmp_path / "mh.npz")
    part.config = cfg
    part.save_checkpoint(ck)
    resumed = mh.MultiHostRenderer.resume_checkpoint(cs, ck, cfg, device="cpu", host_id=1,
                                                     num_hosts=2)
    assert resumed.sweeps_done == 1 and resumed.sweep_ids == [1, 3, 5]
    resumed.render()
    assert np.array_equal(resumed.film.numpy(), full.film.numpy())


@pytest.mark.parametrize("cls_name", ["MultiHostMultiChipRenderer", "MultiHostMegaRenderer"])
def test_host_stride_times_chip_shard_matches_single(scenes, cls_name):
    """Sweeps stride over two simulated hosts while each host shards its
    sweeps over two devices (tests/test_multichip.py:191-224)."""
    _, cs = scenes
    cfg = RenderConfig(width=64, height=128, spp=3, block_size=64, seed=7, max_bounces=8,
                       driver="mega" if cls_name == "MultiHostMegaRenderer" else "sync")
    films = []
    for h in range(2):
        r = getattr(mh, cls_name)(cs, cfg, host_id=h, num_hosts=2, num_devices=2, device="cpu")
        m = r.render()
        assert m["host_id"] == h and m["devices"] == 2 and m["wave_overflow"] == 0
        films.append(r.film)
    ref = Renderer(cs, cfg, device="cpu")
    ref.render()
    np.testing.assert_allclose(mh.merge_films(films).numpy(), ref.film.numpy(),
                               rtol=1e-4, atol=2e-4)


_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, store, out, cls, repo = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5]
rank = int(rank)
sys.path.insert(0, repo)
dist.init_process_group("gloo", init_method=f"file://{store}", world_size=2, rank=rank)
from hijiki_tpu_torch.parallel import multihost as mh
from hijiki_tpu_torch.render.renderer import RenderConfig
from hijiki_tpu_torch.scene.compile import compile_scene
from hijiki_tpu_torch.scene.obj import load_obj_scene

scene = load_obj_scene(f"{repo}/scenes/meshbox/meshbox_small.obj")
scene.put_cbox_spheres()
cfg = RenderConfig(width=64, height=64, spp=3, block_size=64, seed=7, max_bounces=8,
                   driver="mega" if cls == "MultiHostMegaRenderer" else "sync")
r = getattr(mh, cls)(compile_scene(scene), cfg, device="cpu")  # topology from the group
assert (r.num_hosts, r.host_id) == (2, rank), (r.num_hosts, r.host_id)
r.render()
np.save(f"{out}.{rank}.npy", r.merged_film().numpy())
dist.destroy_process_group()
print("worker", rank, "ok", flush=True)
"""


@pytest.mark.parametrize("cls", ["MultiHostRenderer", "MultiHostMegaRenderer"])
def test_two_processes_merge_over_gloo(tmp_path, scenes, cls):
    """Two real processes: each traces its stride; merged_film() gathers the
    films over the process group and every rank holds the same merge,
    equal to the single-process render."""
    _, cs = scenes
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    out = str(tmp_path / "merged")
    procs = [subprocess.Popen([sys.executable, str(script), str(rank), str(tmp_path / "store"),
                               out, cls, REPO],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=dict(os.environ, OMP_NUM_THREADS="1"))
             for rank in (0, 1)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{log[-2000:]}"
    m0, m1 = np.load(f"{out}.0.npy"), np.load(f"{out}.1.npy")
    assert np.array_equal(m0, m1)
    cfg = RenderConfig(width=64, height=64, spp=3, block_size=64, seed=7, max_bounces=8,
                       driver="mega" if cls == "MultiHostMegaRenderer" else "sync")
    ref = Renderer(cs, cfg, device="cpu")
    ref.render()
    np.testing.assert_allclose(m0, ref.film.numpy(), rtol=1e-4, atol=2e-4)
