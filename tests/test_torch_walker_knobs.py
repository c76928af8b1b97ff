"""The TPU walker's knobs in the port: the one check they carry off the TPU
(the lane sort's 128-lane packet, JAX's resolve_mega_packet,
hijiki_tpu/render/renderer.py:534) against hijiki_tpu's on a grid of
requested values, errors included; and the CLI with every knob set (and
--profile-dir) writing the EXR of the command without them, bit for bit.
The JAX resolver reads a HIJIKI_MEGA_PACKET override that the port leaves
out: it is not set here."""

import itertools

import numpy as np
import pytest

from hijiki_tpu.render import renderer as jr
from hijiki_tpu_torch import cli
from hijiki_tpu_torch.render import renderer as pr
from hijiki_tpu_torch.utils.exr import read_exr
from torch_port_helpers import MESHBOX_SMALL

GRID = (-3, -1, 0, 1, 2, 4, 128, 256, 1024)


@pytest.fixture(autouse=True)
def _no_overrides(monkeypatch):
    monkeypatch.delenv("HIJIKI_MEGA_PACKET", raising=False)


def _same(port_fn, jax_fn):
    """Both return the same value, or both raise ValueError with one message."""
    try:
        want = jax_fn()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port_fn()
        assert str(got.value) == str(e).replace("--mega-packet/HIJIKI_MEGA_PACKET", "--mega-packet")
        return
    assert port_fn() == want


@pytest.mark.parametrize("requested,sort_lanes", itertools.product(GRID, (False, True)))
def test_resolvers_match_jax_off_the_tpu(requested, sort_lanes):
    _same(lambda: pr.resolve_mega_packet(requested, sort_lanes),
          lambda: jr.resolve_mega_packet(requested, sort_lanes))


def test_cli_every_knob_same_exr(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = [MESHBOX_SMALL, "--put-cbox-spheres", "--use-bvh", "--driver", "mega", "-w", "32",
            "-H", "32", "-s", "2", "--max-bounces", "8", "--device", "cpu"]
    knobs = ["--mega-packet", "256", "--mega-groups", "4", "--spec-resolve", "1",
             "--mega-trunk", "4096", "--mega-window", "2", "--profile-dir", "prof",
             "--metrics-json", "m.json"]
    assert cli.main([*base, "-o", "plain.exr"]) == 0
    assert cli.main([*base, *knobs, "-o", "knobs.exr"]) == 0
    np.testing.assert_array_equal(read_exr("knobs.exr").view(np.int32),
                                  read_exr("plain.exr").view(np.int32))
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


def test_sort_lanes_refuses_another_packet():
    with pytest.raises(ValueError, match="sort_lanes requires 128-lane packets"):
        pr.Renderer(None, pr.RenderConfig(sort_lanes=True, mega_packet=256), device="cpu")
