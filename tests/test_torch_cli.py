"""The port's CLI: CPU renders that write an EXR (chained, checkpointed,
traced, with previews; every driver), and refusal of the flags that are not
ported yet."""

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


@pytest.mark.parametrize("flags", [["--mega-packet=1024"], ["--profile-dir", "p"], ["--mega-groups", "2"],
                                   ["--spec-resolve", "1", "--driver", "mega"]])
def test_cli_refuses_unported_flags(flags, tmp_path, monkeypatch):
    """The flags the port once refused are ported: each renders the image
    the command without it writes, bit for bit (the walker knobs schedule
    the TPU's packet walk; --profile-dir writes a trace beside it)."""
    monkeypatch.chdir(tmp_path)
    base = ["builtin:cornell", "-w", "16", "-H", "16", "-s", "1", "--max-bounces", "6",
            "--device", "cpu"]
    assert cli.main([*base, "-o", "plain.exr"]) == 0
    assert cli.main([*base, *flags, "-o", "knob.exr"]) == 0
    np.testing.assert_array_equal(read_exr("knob.exr").view(np.int32),
                                  read_exr("plain.exr").view(np.int32))
    if "--profile-dir" in flags:
        assert (tmp_path / "p" / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("flags", [
    ["--driver", "sync", "--use-bvh"],
    ["--driver", "sync"],  # no BVH: brute force
    ["--driver", "wavefront", "--use-bvh", "--sort-lanes"],
    ["--driver", "sync", "--use-bvh", "--fixed-albedo"],
    ["--driver", "mega", "--fixed-albedo"],
    ["--driver", "mega", "--use-bvh", "--sort-lanes"],
], ids=["sync", "sync-brute", "wavefront-sorted", "sync-albedo", "mega-albedo", "mega-sorted"])
def test_cli_drivers(flags, tmp_path):
    out, mj = tmp_path / "d.exr", tmp_path / "m.json"
    assert cli.main([MESHBOX_SMALL, "--put-cbox-spheres", *flags, "-w", "24", "-H", "16", "-s", "1",
                     "--max-bounces", "10", "--device", "cpu", "-o", str(out),
                     "--metrics-json", str(mj)]) == 0
    img = read_exr(str(out))
    assert img.shape == (16, 24, 3) and np.isfinite(img).all() and img.mean() > 0
    m = json.loads(mj.read_text())
    assert m["config"]["driver"] == flags[1]
    assert m["config"]["fixed_albedo"] == ("--fixed-albedo" in flags)


def test_cli_fixed_albedo_needs_sync_or_mega(capsys):
    assert cli.main(["builtin:cornell", "--driver", "wavefront", "--fixed-albedo"]) == 2
    assert "requires the sync or mega driver" in capsys.readouterr().err


def test_cli_chained_checkpoint_trace_preview(tmp_path, capsys):
    """--chain-sweeps, --checkpoint(-interval), --trace-json and
    --present-interval together; a second run with more sweeps resumes from
    the checkpoint."""
    ck, trace, png = tmp_path / "ck.npz", tmp_path / "t.json", tmp_path / "p.png"
    base = [MESHBOX_SMALL, "--put-cbox-spheres", "--put-dielectric-sphere", "--use-bvh",
            "-w", "32", "-H", "24", "--max-bounces", "12", "--device", "cpu",
            "--chain-sweeps", "2", "--checkpoint", str(ck), "--checkpoint-interval", "2",
            "--trace-json", str(trace), "--present-interval", "3", "--preview-image", str(png),
            "-o", str(tmp_path / "o.exr"), "--metrics-json", str(tmp_path / "m.json")]
    assert cli.main(base + ["-s", "4"]) == 0
    assert png.exists()  # sweeps 2 -> 4 cross the interval 3
    names = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]]
    assert names.count("dispatch chained chunk") == 2 and "film ready" in names
    # saves at sweeps 2 and 4 (the final save comes after the trace is written)
    assert names.count("checkpoint save") == 2
    assert int(np.load(ck)["sweeps_done"]) == 4
    m = json.loads((tmp_path / "m.json").read_text())
    assert m["metrics"]["chain_chunk_sweeps"] == 2 and m["sweeps_done"] == 4
    capsys.readouterr()
    assert cli.main(base + ["-s", "6"]) == 0
    assert "Resumed from" in capsys.readouterr().out
    assert int(np.load(ck)["sweeps_done"]) == 6
    m = json.loads((tmp_path / "m.json").read_text())
    assert m["metrics"]["primary_rays"] == 32 * 24 * 2  # only the resumed sweeps
    img = read_exr(str(tmp_path / "o.exr"))
    assert np.isfinite(img).all() and img.mean() > 0


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


@pytest.mark.parametrize("driver", ["mega", "sync"])
def test_cli_devices_resume_across_device_counts(driver, tmp_path, capsys):
    """--devices 2 with --platform cpu (the alias of --device cpu): two row
    bands (mega) or the blocks over two devices (sync). A checkpoint of the
    one-device render resumes on two devices, and the image equals the
    one-device render of all the sweeps (the films' float sums aside)."""
    base = [MESHBOX_SMALL, "--put-cbox-spheres", "--use-bvh", "--driver", driver,
            "-w", "32", "-H", "128", "--block-size", "64", "--max-bounces", "8"]
    one, two, ck, mj = (tmp_path / n for n in ("1.exr", "2.exr", "ck.npz", "m.json"))
    assert cli.main(base + ["-s", "2", "--device", "cpu", "-o", str(one)]) == 0
    assert cli.main(base + ["-s", "1", "--device", "cpu", "--checkpoint", str(ck),
                            "-o", str(two)]) == 0
    capsys.readouterr()
    assert cli.main(base + ["-s", "2", "--platform", "cpu", "--devices", "2", "--checkpoint",
                            str(ck), "-o", str(two), "--metrics-json", str(mj)]) == 0
    out = capsys.readouterr().out
    assert "Resumed from" in out and "x 2 devices" in out
    m = json.loads(mj.read_text())
    assert m["devices"] == 2 and m["metrics"]["devices"] == 2 and m["device"] == "cpu"
    assert m["metrics"]["primary_rays"] == 32 * 128
    np.testing.assert_allclose(read_exr(str(two)), read_exr(str(one)), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("flags,error", [
    (["--devices", "3", "-H", "128"], "divide evenly into device bands"),
    (["--devices", "2", "-H", "128", "--block-size", "128"],
     "band height 64 must be a multiple of block_size 128"),
    (["--devices", "2", "--device", "cuda"], "CUDA devices"),
])
def test_cli_devices_errors(flags, error):
    """A band that does not divide raises the reference's error; so does
    asking for more CUDA devices than are present (the card machine has
    one)."""
    argv = ["builtin:cornell", "-w", "32", "--block-size", "64", "-s", "1", "--device", "cpu",
            *flags]
    with pytest.raises(ValueError, match=error):
        cli.main(argv)


def test_cli_platform_tpu_refused(capsys):
    assert cli.main(["builtin:cornell", "--platform", "tpu"]) == 2
    assert "the TPU is the JAX package's" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["--packed-leaf", "4"], ["--packed-leaf", "auto", "--mega-shadow", "1"],
                                   ["--packed-leaf", "12", "--mega-shadow", "-1"]],
                         ids=["packed4", "auto-shadow", "packed12"])
def test_cli_packed_leaf_and_mega_shadow(flags, tmp_path):
    """--packed-leaf and --mega-shadow reach the compile and the renderer:
    the same EXR as the default flags, bit for bit."""
    base = [MESHBOX_SMALL, "--put-cbox-spheres", "--driver", "mega", "-w", "24", "-H", "16",
            "-s", "1", "--max-bounces", "10", "--device", "cpu"]
    ref, out = tmp_path / "ref.exr", tmp_path / "o.exr"
    assert cli.main(base + ["-o", str(ref)]) == 0
    assert cli.main(base + flags + ["-o", str(out)]) == 0
    np.testing.assert_array_equal(read_exr(str(out)), read_exr(str(ref)))
