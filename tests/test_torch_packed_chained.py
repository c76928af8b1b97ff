"""The chained path (``render_waves_chained``: the K4 twin and the K2 twin's
resume phases) on every packed trace-row format and on the classic rows
with the dedicated shadow table, the shadow-visibility boxes on in each,
against hijiki_tpu's chained TPU kernel in interpret mode.

Bounds as tests/test_torch_chained.py states them: >= 99.5% of samples
agree on radiance within rtol/atol 2e-3 (the silhouette/t-tie reroute
class), and the RNG is bit-equal on >= 99.5% of the samples the TPU kernel
returns one for (the parked ones: it leaves a sample that finished inside
the chained launch at RNG 0)."""

import numpy as np
import pytest

import jax.numpy as jnp

from hijiki_tpu.ops import pallas_megakernel as jmk
from hijiki_tpu.scene.compile import compile_scene as j_compile, scene_to_device
from hijiki_tpu.scene.obj import load_obj_scene as j_load
from hijiki_tpu_torch.ops import megakernel as mk
from test_torch_chained import H, W, _tt, chained_inputs
from torch_port_helpers import MESHBOX_SMALL, port_scene

# (packed_leaf, dedicated shadow table)
CONFIGS = {"slim": (1, False), "packed3": (3, False), "packed4": (4, False),
           "packed12": (12, False), "shadow_tbl": (0, True)}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_chained_matches_tpu_kernel_per_format(config):
    packed, tbl = CONFIGS[config]
    s = j_load(MESHBOX_SMALL)
    s.put_cbox_spheres()
    jcs = j_compile(s, packed_leaf=packed)
    ms = mk.mega_scene(port_scene(jcs), W, H, "cpu")
    assert ms.packed == packed and ms.nbox > 0
    pxs, pys, sds = chained_inputs(2)
    jc = jmk.render_waves_chained(
        scene_to_device(jcs), jnp.asarray(pxs), jnp.asarray(pys), jnp.asarray(sds), width=W,
        height=H, max_bounces=12, chain_cap=4, interpret=True, shadow_tbl=tbl,
    )
    tc = mk.render_waves_chained(ms, *_tt(pxs, pys, sds), max_bounces=12, chain_cap=4,
                                 shadow_tbl=tbl)
    assert int(jc[4]) == 0 and int(tc[4]) == 0
    close = np.isclose(np.asarray(jc[0]), tc[0].numpy(), rtol=2e-3, atol=2e-3).all(-1)
    assert close.mean() >= 0.995, f"radiance differs on {1 - close.mean():.3%} of samples"
    js, ts = np.asarray(jc[3]), tc[3].numpy().view(np.uint32)
    parked = js != 0
    assert parked.any() and (js[parked] == ts[parked]).mean() >= 0.995
    assert float(tc[0].mean()) > 0.01
