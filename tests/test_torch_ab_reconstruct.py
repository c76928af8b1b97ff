"""K9, the pre-hoisting reconstruction stencil of the port
(hijiki_tpu_torch/probes/ab_reconstruct.py), against the JAX tool it
replaces (tools/ab_reconstruct.py::reconstruct_old, interpret mode on the
CPU) and against the port's K3.

The plain version gets the tool's inputs (numpy-seeded color and normals,
some pixels NaN) and must compute _old_kernel's (H, W, 4) film delta.
Tolerances, measured on the CPU: not bit for bit against JAX, because XLA's
CPU backend contracts a*b + c into FMAs (offx^2 + offy^2, the normal
distance) and its exp is not torch's: about 10% of the outputs differ, by
at most 4.6e-7 relative (rtol 1e-6 below). Against the port's K3 plain
version (render/reconstruct.py::reconstruct_sweep), which associates the
tap offset as dx + (so - 0.5) and takes exp of a 0-d tensor for the spatial
weights, 0.1-0.2% of the outputs differ, by at most 1.7e-7 relative (rtol
5e-7, at most 1% of the outputs). The NaN pixels' taps are dropped on both
sides: no output is NaN.
"""

from __future__ import annotations

import functools
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hijiki_tpu_torch.probes import ab_reconstruct as K9
from hijiki_tpu_torch.render.pallas_reconstruct import reconstruct as k3
from torch_port_helpers import REPO

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

SO = np.float32([0.37, 0.61])


def _tool(monkeypatch):
    import importlib

    mod = importlib.import_module("ab_reconstruct")
    monkeypatch.setattr(mod.pl, "pallas_call", functools.partial(mod.pl.pallas_call, interpret=True))
    return mod


def _inputs(H, W, nan=True):
    rng = np.random.default_rng(0)
    color = rng.random((H, W, 3), np.float32)
    normal = rng.random((H, W, 3), np.float32) * 2 - 1
    if nan:
        color[3, 5, 1] = np.nan
        color[H - 1, W - 2, 0] = np.nan
        normal[H // 2, 10, 2] = np.nan
    return color, normal


@pytest.mark.parametrize("H,W,block", [(37, 64, 16), (64, 64, 128), (40, 48, 16), (40, 48, 12)],
                         ids=["partial-strip-block16", "one-block", "spill-block16", "spill-block12"])
def test_old_matches_jax(monkeypatch, H, W, block):
    ab = _tool(monkeypatch)
    color, normal = _inputs(H, W)
    want = np.asarray(ab.reconstruct_old(jnp.asarray(color), jnp.asarray(normal), jnp.asarray(SO),
                                         block_size=block))
    got = K9.reconstruct_old(torch.from_numpy(color), torch.from_numpy(normal),
                             torch.from_numpy(SO), block_size=block).numpy()
    assert got.shape == (H, W, 4) and np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got == want).mean() > 0.8
    # the NaN taps are dropped, not zeroed into a valid weight: the pixels
    # around a NaN normal weigh less than without it
    clean = K9.reconstruct_old(*(torch.from_numpy(a) for a in _inputs(H, W, nan=False)),
                               torch.from_numpy(SO), block_size=block).numpy()
    assert (got[..., 3] < clean[..., 3]).sum() >= 9


@pytest.mark.parametrize("H,W,block", [(37, 64, 16), (64, 64, 128)])
def test_old_plain_matches_k3_plain(H, W, block):
    """K9 and K3 compute one filter (the tool's A/B found them bitwise equal
    on the TPU); the port's two plain versions differ by their rounding."""
    color, normal = (torch.from_numpy(a) for a in _inputs(H, W))
    so = torch.from_numpy(SO)
    old = K9.reconstruct_old(color, normal, so, block_size=block)
    new = k3(color, normal, so, block_size=block)
    np.testing.assert_allclose(old.numpy(), new.numpy(), rtol=5e-7, atol=1e-8)
    assert K9.differing_pixels(old, new) <= 0.01 * H * W * 4


@pytest.mark.parametrize("B", [1, 2, 3, 7, 8, 100, 127, 128, 129, 1000, 1024, 4096])
def test_divisor_constants_floor_divide(B):
    """The kernel's floor division by B (csrc/reconstruct_old.cu::floordiv)
    with the host's constants, step for step on int64 tensors: n = q, or
    B - 1 - q for q < 0; the high 32 bits of (2n) m; shifted by s; negated
    for q < 0. It equals q // B for every q in [-2, 4098), the taps of a
    4096-wide image, and m fits 32 unsigned bits."""
    m, s = K9.divisor_constants(B)
    assert 1 << 31 <= m < 1 << 32 and (1 << s) >= B > (1 << s) // 2
    q = torch.arange(-2, 4098, dtype=torch.int64)
    n = torch.where(q >= 0, q, B - 1 - q)
    assert int(2 * n.max()) < 1 << 32  # the kernel's 2n in 32 unsigned bits
    d = ((2 * n * m) >> 32) >> s
    got = torch.where(q >= 0, d, -d)
    assert torch.equal(got, torch.div(q, B, rounding_mode="floor"))


def _k9_sass(ops, loop_ops):
    """sass_functions' form of one reconstruct_old_kernel: ``ops`` before a
    rolled tap loop of ``loop_ops``."""
    code = [(op, "") for op in ops + loop_ops + ["BRA", "EXIT"]]
    return {"_ZN12_GLOBAL__N_122reconstruct_old_kernelEPKfiiiijiffffPf":
            (code, [(len(ops), len(ops) + len(loop_ops))], "")}


@pytest.mark.parametrize("case", ["clean", "division", "global_taps", "unrolled"])
def test_check_tap_divisions(monkeypatch, case):
    """check_tap_divisions passes K9's code without MUFU.RCP whose tap loop
    is one tap reading shared memory, and names a run-time division (the
    first version's two a tap), taps read from device memory, or a loop of
    more taps."""
    import hijiki_tpu_torch.probes as probes

    stage = ["LDG.E"] * 7 + ["STS.128"] * 2 + ["BAR.SYNC.DEFER_BLOCKING"]
    tap = ["IMAD.HI.U32", "SHF.R.U32.HI", "MUFU.EX2", "LDS.128", "LDS.128", "MUFU.EX2", "FADD"]
    loop = {"clean": tap, "division": tap + ["I2FP.F32.U32", "MUFU.RCP", "F2I.FTZ.U32.TRUNC"],
            "global_taps": tap + ["LDG.E"], "unrolled": tap * 5}[case]
    monkeypatch.setattr(probes, "sass_functions", lambda kernel, lib=None: _k9_sass(stage, loop))
    if case == "clean":
        got = K9.check_tap_divisions()
        assert got["MUFU.RCP"] == 0 and got["tap_loop_taps"] == 1 and got["tap_loop_LDS"] == 2
        assert got["per_tap"] == len(loop) + 1  # the back branch
        return
    what = {"division": "1 MUFU.RCP", "global_taps": "1 LDG in the tap loop",
            "unrolled": "a tap loop of 5 taps"}[case]
    with pytest.raises(RuntimeError, match=what):
        K9.check_tap_divisions()


def test_planes_and_constants():
    """The tool's planes (padded to 8-row strips with zeros), its f32
    constants, and the CPU path, which counts no launch."""
    color, normal = (torch.from_numpy(a) for a in _inputs(37, 16, nan=False))
    planes = K9.planes_of(color, normal)
    assert planes.shape == (7, 40, 16)
    assert torch.equal(planes[3, :37], torch.ones(37, 16)) and (planes[:, 37:] == 0).all()
    assert torch.equal(planes[4:, :37], normal.permute(2, 0, 1))
    gauss, curve = K9.constants(0.5)
    assert gauss == -2.0 and curve == float(np.float32(math.exp(-8.0)))
    before = K9.LAUNCHES["reconstruct_old"]
    a = K9.reconstruct_old_planes(planes, 37, SO, block_size=16)
    assert K9.LAUNCHES["reconstruct_old"] == before
    assert torch.equal(a, K9.reconstruct_old(color, normal, SO, block_size=16))


@pytest.mark.parametrize("argv", [["--device", "cpu", "48"], ["--device", "cpu", "instream", "32"]],
                         ids=["ab", "instream"])
def test_main_on_cpu(argv, capsys, tmp_path):
    out_json = tmp_path / "r.json"
    assert K9.main(argv + ["--json", str(out_json)]) == 0
    out = capsys.readouterr().out
    assert "not timed" in out and " ms" not in out and out_json.exists()
    if "instream" not in argv:
        assert "K9 (old) against K3 at 48x48" in out


def test_main_without_card_is_an_error():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "hijiki_tpu_torch.probes.ab_reconstruct", "64"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "no CUDA card" in r.stderr and "ms" not in r.stdout
