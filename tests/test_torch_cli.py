"""The port's CLI: a CPU render that writes an EXR, and refusal of the
flags that are not ported yet."""

import json
import subprocess
import sys

import numpy as np
import pytest

from hijiki_tpu_torch import cli
from hijiki_tpu_torch.utils.exr import read_exr
from torch_port_helpers import MESHBOX_SMALL, REPO


def test_cli_renders_exr(tmp_path, capsys):
    out = tmp_path / "out.exr"
    rc = cli.main([MESHBOX_SMALL, "--put-cbox-spheres", "--use-bvh", "--driver", "mega",
                   "-w", "32", "-H", "24", "-s", "2", "--max-bounces", "50", "--device", "cpu",
                   "-o", str(out), "--metrics-json", str(tmp_path / "m.json")])
    assert rc == 0
    img = read_exr(str(out))
    assert img.shape == (24, 32, 3) and np.isfinite(img).all() and img.mean() > 0
    m = json.loads((tmp_path / "m.json").read_text())
    assert m["metrics"]["primary_rays"] == 32 * 24 * 2 and m["device"] == "cpu"
    assert "Mrays/s" in capsys.readouterr().out


def test_cli_builtin_scene(tmp_path):
    out = tmp_path / "b.exr"
    assert cli.main(["builtin:cornell-spheres", "-w", "16", "-H", "16", "-s", "1",
                     "--max-bounces", "8", "--device", "cpu", "-o", str(out)]) == 0
    assert read_exr(str(out)).shape == (16, 16, 3)


@pytest.mark.parametrize("flag", ["--checkpoint=x.npz", "--devices", "--sort-lanes", "--chain-sweeps"])
def test_cli_refuses_unported_flags(flag, capsys):
    assert cli.main(["builtin:cornell", flag, "2"] if "=" not in flag else ["builtin:cornell", flag]) == 2
    assert "not ported yet" in capsys.readouterr().err


def test_cli_module_entry_point(tmp_path):
    """``python -m hijiki_tpu_torch.cli`` in a fresh interpreter."""
    out = tmp_path / "m.exr"
    r = subprocess.run(
        [sys.executable, "-m", "hijiki_tpu_torch.cli", "builtin:cornell", "-w", "16", "-H", "16",
         "-s", "1", "--max-bounces", "6", "--device", "cpu", "-o", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert out.exists() and "Wrote" in r.stdout
