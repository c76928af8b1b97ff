"""``render_waves(shadow_skip_all=True)``, JAX's performance probe (every
shadow walk skipped with visibility 1: a biased image), of the megakernel's
plain twin against hijiki_tpu's in interpret mode, with the bounds of
tests/test_torch_shadow_cache.py; and the errors of the shadow options that
exclude each other, raised as JAX raises them."""

import jax.numpy as jnp
import pytest
import torch

from hijiki_tpu.ops import pallas_megakernel as jmk
from hijiki_tpu.scene.compile import scene_to_device
from hijiki_tpu_torch.ops import megakernel as mk
from test_torch_megakernel import assert_paths_agree
from test_torch_shadow_cache import BOUNCES, H, W, _inputs, _jax_scene
from torch_port_helpers import port_scene


def test_skip_all_matches_jax():
    """JAX's probe switch: every shadow walk skipped, visible (a biased
    image: brighter than the unbiased one)."""
    jcs = _jax_scene("meshbox_small")
    ms = mk.mega_scene(port_scene(jcs), W, H, "cpu")
    (px, py, seeds), targs = _inputs()
    jw = jmk.render_waves(scene_to_device(jcs), jnp.asarray(px), jnp.asarray(py),
                          jnp.asarray(seeds), width=W, height=H, max_bounces=BOUNCES,
                          phase_bounces=(5, 8), interpret=True, shadow_skip_all=True)
    tw = mk.render_waves(ms, *targs, max_bounces=BOUNCES, phase_bounces=(5, 8),
                         shadow_skip_all=True)
    assert int(jw[4]) == 0 and int(tw[4]) == 0
    assert_paths_agree(jw[3], tw[3], jw[0], tw[0])
    fair = mk.render_waves(ms, *targs, max_bounces=BOUNCES, phase_bounces=(5, 8))
    assert float(tw[0].mean()) > float(fair[0].mean())
    # the RNG draws are the unbiased render's: only the walks were skipped
    assert torch.equal(tw[3], fair[3])
    assert float(tw[6].sum()) < float(fair[6].sum())


def test_cache_exclusions_raise_as_jax():
    """shadow_cache with the dedicated shadow table, and shadow_skip_all with
    shadow_cache, raise ValueError naming the option (JAX's
    _check_shadow_tbl and _bounce_loop)."""
    jcs = _jax_scene("meshbox_small")
    assert jcs.shadow_rows_mega is not None
    ms = mk.mega_scene(port_scene(jcs), W, H, "cpu")
    (px, py, seeds), targs = _inputs()
    with pytest.raises(ValueError, match="shadow_cache"):
        mk.render_tiles(ms, *targs, max_bounces=2, shadow_tbl=True, shadow_cache=True)
    with pytest.raises(ValueError, match="shadow_cache"):
        mk.render_waves_chained(ms, *(torch.stack([t, t]) for t in targs), max_bounces=2,
                                shadow_tbl=True, shadow_cache=True)
    with pytest.raises(ValueError, match="shadow_skip_all"):
        mk.render_waves(ms, *targs, max_bounces=2, shadow_cache=True, shadow_skip_all=True)
    with pytest.raises(ValueError, match="shadow_cache"):
        jmk.render_tiles(scene_to_device(jcs), jnp.asarray(px), jnp.asarray(py),
                         jnp.asarray(seeds), width=W, height=H, max_bounces=2, interpret=True,
                         shadow_tbl=True, shadow_cache=True)
